"""Port diarization (turbo_whisper_workspace_tpu_torch: models/segmentation.py,
models/embedding.py, pipeline/diarizer.py, the converter's `.npz` I/O)
against the JAX package on the CPU, on the same weights and numpy inputs.

Tolerances:
* f32 forwards: segmentation logits within 1e-4 absolute (measured
  1.4e-6 of a 2.5 peak), embeddings and spectral specs within 1e-5
  (measured 1.5e-7 and 2.4e-7);
* f32 turns (fallback tier, trained tier): equal, and DER equal;
* clustering: labels equal to scikit-learn's, exactly;
* bf16 through `from_names`: segmentation logits within 1e-2 relative
  L2 of the JAX bf16 forward (measured 3.9e-3, the JAX bf16 forward's
  own distance from f32), speech probabilities within 2e-2 (measured
  6.1e-3); turns with the same speakers, each boundary within 0.2 s
  (two frames; measured one frame at one boundary of 48), DER within
  0.01 of the JAX package's (measured equal).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.cluster import AgglomerativeClustering

import turbo_whisper_workspace_tpu.pipeline.diarizer as jdz
from turbo_whisper_workspace_tpu.config import DiarizationConfig as JDConfig
from turbo_whisper_workspace_tpu.models import convert as jconvert
from turbo_whisper_workspace_tpu.models import embedding as jemb
from turbo_whisper_workspace_tpu.models import segmentation as jseg
from turbo_whisper_workspace_tpu.ops import mel as jmel
from turbo_whisper_workspace_tpu.utils.metrics import der as jder
from turbo_whisper_workspace_tpu_torch.config import DiarizationConfig
from turbo_whisper_workspace_tpu_torch.models import convert
from turbo_whisper_workspace_tpu_torch.models import embedding as temb
from turbo_whisper_workspace_tpu_torch.models import segmentation as tseg
from turbo_whisper_workspace_tpu_torch.pipeline import diarizer as tdz
from turbo_whisper_workspace_tpu_torch.utils.metrics import der
from tests.test_diarization import _two_speaker_audio
from tests.test_diarization_der import _train_embedder, _train_segmenter, make_conversation
from tests.test_diarizer_batching import _speech_like

SR = 16000


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _port_dims(cls, dims):
    return cls(**dataclasses.asdict(dims))


def _turns(segs):
    return [s.to_dict() for s in segs]


def _port_diarizer(config, seg_params=None, seg_dims=None, emb_params=None,
                   emb_dims=None):
    """The port's diarizer on the weights of JAX trees (f32)."""
    kw = {}
    if seg_params is not None:
        kw["seg_dims"] = _port_dims(tseg.SegmentationDims, seg_dims)
        kw["seg_params"] = convert.segmentation_from_jax_params(
            _np_tree(seg_params), kw["seg_dims"])
    if emb_params is not None:
        kw["emb_dims"] = _port_dims(temb.EmbeddingDims, emb_dims)
        kw["emb_params"] = convert.embedding_from_jax_params(
            _np_tree(emb_params), kw["emb_dims"])
    return tdz.SpeakerDiarizer(config, device="cpu", **kw)


# ---------------------------------------------------------------------------
# Forwards


def test_segmentation_forward_matches_jax():
    dims = jseg.SegmentationDims(d_model=64, n_head=2, n_layer=2)
    params = jseg.init_params(dims, jax.random.PRNGKey(0))
    model = convert.segmentation_from_jax_params(
        _np_tree(params), _port_dims(tseg.SegmentationDims, dims))
    mel = np.random.default_rng(1).standard_normal((3, 80, 1000)).astype(np.float32)
    ref = np.asarray(jseg.forward(params, dims, mel))
    got = model(torch.from_numpy(mel)).numpy()
    assert got.shape == (3, tseg.FRAMES_PER_WINDOW, tseg.N_CLASSES) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    np.testing.assert_allclose(tseg.powerset_speech_prob(got),
                               jseg.powerset_speech_prob(ref), rtol=0, atol=1e-5)


def test_embedding_forward_matches_jax():
    dims = jemb.EmbeddingDims(channels=64, n_blocks=2, embed_dim=32)
    params = jemb.init_params(dims, jax.random.PRNGKey(1))
    model = convert.embedding_from_jax_params(
        _np_tree(params), _port_dims(temb.EmbeddingDims, dims))
    mel = np.random.default_rng(2).standard_normal((3, 80, 200)).astype(np.float32)
    ref = np.asarray(jemb.forward(params, dims, mel))
    got = model(torch.from_numpy(mel)).numpy()
    assert got.shape == (3, 32)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)


def test_spectral_spec_matches_jax():
    """The fallback's device half on the same int16 crops, and the host
    half (shared numpy code) on its output."""
    pcm = (np.random.default_rng(3).standard_normal((4, 2 * SR)) * 3000).astype(np.int16)
    ref = np.asarray(jemb.spectral_spec_device(jnp.asarray(pcm)))
    got = temb.spectral_spec_device(torch.from_numpy(pcm)).numpy()
    assert got.shape == (4, 80)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(temb.spectral_embedding_from_spec(got),
                               jemb.spectral_embedding_from_spec(ref), rtol=0, atol=1e-4)
    # the host form of the same function, on a host mel
    mel = np.asarray(jmel.log_mel_spectrogram(jnp.asarray(pcm)))[:, :, :200]
    np.testing.assert_allclose(temb.spectral_embedding(mel), jemb.spectral_embedding(mel),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(temb.spectral_embedding(mel),
                               temb.spectral_embedding_from_spec(got), rtol=0, atol=1e-3)


def test_random_init_modules_have_jax_shapes():
    """The port's init gives the JAX tree's leaves, shape for shape."""
    gen = torch.Generator().manual_seed(0)
    for jmod, tmod, dims in (
            (jseg, tseg, jseg.SegmentationDims(d_model=64, n_head=2, n_layer=2)),
            (jemb, temb, jemb.EmbeddingDims(channels=64, n_blocks=2, embed_dim=32))):
        model = tmod.init_params(_port_dims(getattr(tmod, type(dims).__name__), dims), gen)
        want = jax.tree.map(np.shape, _np_tree(jmod.init_params(dims, jax.random.PRNGKey(0))))
        got = jax.tree.map(np.shape, convert.jax_params_from_module(model))
        assert got == want


# ---------------------------------------------------------------------------
# Converter, both ways


def test_jax_checkpoint_loads_in_port(tmp_path):
    dims = jseg.SegmentationDims(d_model=64, n_head=2, n_layer=2)
    params = jseg.init_params(dims, jax.random.PRNGKey(4), dtype=jnp.bfloat16)
    path = str(tmp_path / "seg-x.npz")
    jconvert.save_params(path, params, meta=dataclasses.asdict(dims))
    assert convert.load_meta(path) == jconvert.load_meta(path) == dataclasses.asdict(dims)
    ref = jconvert.load_params(path, dtype=jnp.bfloat16)
    got = convert.load_params(path, dtype=torch.bfloat16)
    for (kr, r), (kg, g) in zip(jax.tree_util.tree_leaves_with_path(ref),
                                jax.tree_util.tree_leaves_with_path(got)):
        assert kr == kg and g.dtype == torch.bfloat16
        np.testing.assert_array_equal(g.float().numpy(), np.asarray(r, np.float32))
    model = convert.segmentation_from_jax_params(
        got, tseg.SegmentationDims(**convert.load_meta(path)), dtype=torch.bfloat16)
    mel = np.random.default_rng(5).standard_normal((2, 80, 1000)).astype(np.float32)
    a = np.asarray(jseg.forward(ref, dims, mel))
    b = model(torch.from_numpy(mel)).numpy()
    assert np.linalg.norm(a - b) / np.linalg.norm(a) < 1e-2


def test_port_checkpoint_loads_in_jax(tmp_path):
    dims = temb.EmbeddingDims(channels=64, n_blocks=2, embed_dim=32)
    model = temb.init_params(dims, torch.Generator().manual_seed(0), dtype=torch.bfloat16)
    path = str(tmp_path / "emb-x.npz")
    convert.save_params(path, model, meta=dataclasses.asdict(dims))
    meta = jconvert.load_meta(path)
    jdims = jemb.EmbeddingDims(**meta)
    params = jconvert.load_params(path, dtype=jnp.bfloat16)
    want = convert.jax_params_from_module(model)
    assert jax.tree.structure(_np_tree(params)) == jax.tree.structure(want)
    for r, w in zip(jax.tree.leaves(params), jax.tree.leaves(want)):
        assert r.dtype == jnp.bfloat16
        np.testing.assert_array_equal(np.asarray(r, np.float32), w)
    mel = np.random.default_rng(6).standard_normal((3, 80, 200)).astype(np.float32)
    ref = np.asarray(jemb.forward(params, jdims, mel))
    got = model(torch.from_numpy(mel)).numpy()
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 2e-2


def test_whisper_tree_round_trips():
    """jax_params_from_module inverts from_jax_params on the Whisper tree
    (`encoder/blocks`, `decoder/blocks`), leaf for leaf."""
    from turbo_whisper_workspace_tpu.models import whisper as jwm
    from turbo_whisper_workspace_tpu_torch.models import whisper as twm

    dims = jwm.WhisperDims(80, 1500, 64, 2, 2, 517, 448, 64, 2, 2)
    params = _np_tree(jwm.init_params(dims, jax.random.PRNGKey(0)))
    back = convert.jax_params_from_module(
        convert.from_jax_params(params, twm.WhisperDims(**dims.__dict__)))
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# Clustering against scikit-learn


def _embs(seed, n, d=8, groups=3):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((groups, d))
    x = centers[rng.integers(0, groups, n)] + 0.6 * rng.standard_normal((n, d))
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _sklearn_cluster(embs, num_speakers, threshold, max_speakers):
    """The JAX package's `_cluster` body, scikit-learn and all."""
    d = jdz.SpeakerDiarizer(JDConfig(max_speakers=max_speakers))
    return d._cluster(embs, num_speakers, threshold)


@pytest.mark.parametrize("num_speakers,threshold,max_speakers", [
    (2, 0.5, 10), (3, 0.5, 10),                     # k mode
    (0, 0.3, 10), (0, 0.5, 10), (0, 0.8, 10),       # threshold mode
    (0, 0.3, 2), (5, 0.5, 3),                       # max_speakers forces merges
], ids=["k2", "k3", "thr0.3", "thr0.5", "thr0.8", "thr0.3-cap2", "k5-cap3"])
def test_cluster_matches_sklearn(num_speakers, threshold, max_speakers):
    port = tdz.SpeakerDiarizer(DiarizationConfig(max_speakers=max_speakers), device="cpu")
    for seed in range(12):
        embs = _embs(seed, n=5 + 3 * seed)
        ref = _sklearn_cluster(embs, num_speakers, threshold, max_speakers)
        got = port._cluster(embs, num_speakers, threshold)
        np.testing.assert_array_equal(got, ref)
        assert got.max() < max_speakers


def test_cluster_single_embedding_and_raw_labels():
    port = tdz.SpeakerDiarizer(DiarizationConfig(), device="cpu")
    one = _embs(0, n=1)
    np.testing.assert_array_equal(port._cluster(one, 2, 0.5), np.zeros(1, np.int32))
    # the labels before the dense relabel (which the max_speakers cap
    # reads) equal sklearn's on random data, ties in merge height included
    rng = np.random.default_rng(0)
    for _ in range(100):
        n = int(rng.integers(2, 30))
        x = rng.integers(-2, 3, (n, 3)).astype(np.float32)     # many tied distances
        x[~x.any(1)] = 1.0
        for kw in ({"n_clusters": min(int(rng.integers(1, 6)), n)},
                   {"n_clusters": None, "distance_threshold": float(rng.uniform(0.1, 1.2))}):
            ref = AgglomerativeClustering(metric="cosine", linkage="average",
                                          **kw).fit_predict(x)
            got = tdz.average_linkage_labels(
                x, n_clusters=kw["n_clusters"], distance_threshold=kw.get("distance_threshold"))
            np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------------------------
# Fallback tier


@pytest.mark.parametrize("seed", [7, 11, 12, 13])
def test_fallback_turns_match_jax(seed):
    audio, truth = make_conversation(np.random.default_rng(seed))
    ref = _turns(jdz.SpeakerDiarizer().process_audio(audio, num_speakers=2))
    got = _turns(tdz.SpeakerDiarizer(device="cpu").process_audio(audio, num_speakers=2))
    assert got == ref
    dur = len(audio) / SR
    assert der(truth, got, duration_s=dur) == jder(truth, ref, duration_s=dur)
    assert der(truth, got, duration_s=dur)["der"] < 0.25


def test_fallback_batch_matches_jax():
    """Several files through one call: the spectral buckets standardise
    across every file's crops and the zero padding, as in JAX."""
    audios = [make_conversation(np.random.default_rng(s), total_s=20.0)[0] for s in (1, 2)]
    audios.append(_two_speaker_audio(np.random.default_rng(1)))
    cfg = dict(emb_batch=16)
    ref = jdz.SpeakerDiarizer(JDConfig(**cfg)).process_batch(audios, num_speakers=0)
    got = tdz.SpeakerDiarizer(DiarizationConfig(**cfg), device="cpu").process_batch(
        audios, num_speakers=0)
    assert [_turns(g) for g in got] == [_turns(r) for r in ref]


# ---------------------------------------------------------------------------
# Trained tier


@pytest.fixture(scope="module")
def trained():
    rng = np.random.default_rng(3)
    emb_params, emb_dims = _train_embedder(rng)
    seg_params, seg_dims = _train_segmenter(rng)
    return seg_params, seg_dims, emb_params, emb_dims


def test_trained_tier_turns_match_jax(trained):
    seg_params, seg_dims, emb_params, emb_dims = trained
    jd = jdz.SpeakerDiarizer(seg_params=seg_params, seg_dims=seg_dims,
                             emb_params=emb_params, emb_dims=emb_dims)
    td = _port_diarizer(DiarizationConfig(), seg_params, seg_dims, emb_params, emb_dims)
    audios, truths = zip(*(make_conversation(np.random.default_rng(s)) for s in (11, 12, 13)))
    ref = jd.process_batch(list(audios), num_speakers=2)
    got = td.process_batch(list(audios), num_speakers=2)
    for r, g, a, truth in zip(ref, got, audios, truths):
        assert g, "neural path produced no turns"
        assert _turns(g) == _turns(r)
        dur = len(a) / SR
        assert der(truth, _turns(g), duration_s=dur) == jder(truth, _turns(r), duration_s=dur)


def test_from_names_bf16_within_tolerance(trained, tmp_path):
    seg_params, seg_dims, emb_params, emb_dims = trained
    jconvert.save_params(str(tmp_path / "seg-synthetic.npz"), seg_params,
                         meta=dataclasses.asdict(seg_dims))
    jconvert.save_params(str(tmp_path / "emb-synthetic.npz"), emb_params,
                         meta=dataclasses.asdict(emb_dims))
    names = dict(segmentation_model="synthetic", embedding_model="synthetic",
                 models_dir=str(tmp_path))
    jd = jdz.SpeakerDiarizer.from_names(JDConfig(), **names)
    td = tdz.SpeakerDiarizer.from_names(DiarizationConfig(), device="cpu", **names)
    assert td.seg_params is not None and td.emb_params is not None
    assert td.seg_params.conv1.weight.dtype == torch.bfloat16
    assert dataclasses.asdict(td.seg_dims) == dataclasses.asdict(seg_dims)
    assert dataclasses.asdict(td.emb_dims) == dataclasses.asdict(emb_dims)
    assert (td.segmentation_model, td.embedding_model) == ("synthetic", "synthetic")

    # segmentation logits of three windows, bf16 in both packages
    audio, _ = make_conversation(np.random.default_rng(11))
    win = np.stack([audio[i * SR:(i + 10) * SR] for i in (0, 5, 10)])
    pcm = np.clip(win * 32768.0, -32768, 32767).astype(np.int16)
    mel = np.array(jmel.log_mel_spectrogram(jnp.asarray(pcm)))[:, :, :1000]
    ref = np.asarray(jseg.forward(jd.seg_params, seg_dims, mel))
    got = td.seg_params(torch.from_numpy(mel)).numpy()
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 1e-2
    assert np.abs(tseg.powerset_speech_prob(got) - jseg.powerset_speech_prob(ref)).max() < 2e-2

    for seed in (11, 12, 13):
        audio, truth = make_conversation(np.random.default_rng(seed))
        r = _turns(jd.process_audio(audio, num_speakers=2))
        g = _turns(td.process_audio(audio, num_speakers=2))
        assert [s["speaker"] for s in g] == [s["speaker"] for s in r]
        for a, b in zip(g, r):
            assert abs(a["start"] - b["start"]) <= 0.2 + 1e-9, (a, b)
            assert abs(a["end"] - b["end"]) <= 0.2 + 1e-9, (a, b)
        dur = len(audio) / SR
        assert abs(der(truth, g, duration_s=dur)["der"]
                   - jder(truth, r, duration_s=dur)["der"]) <= 0.01


def test_from_names_degrades_to_fallback(tmp_path):
    (tmp_path / "seg-broken.npz").write_bytes(b"not a checkpoint")
    d = tdz.SpeakerDiarizer.from_names(
        DiarizationConfig(), segmentation_model="broken", embedding_model="absent",
        models_dir=str(tmp_path), device="cpu")
    assert d.seg_params is None and d.emb_params is None
    assert (d.segmentation_model, d.embedding_model) == ("broken", "absent")
    audio = _two_speaker_audio(np.random.default_rng(1))
    assert _turns(d.process_audio(audio, num_speakers=2)) == _turns(
        jdz.SpeakerDiarizer().process_audio(audio, num_speakers=2))


# ---------------------------------------------------------------------------
# Batching (tests/test_diarizer_batching.py's cases)


@pytest.fixture(scope="module")
def random_nets():
    """tests/test_diarizer_batching.py's random nets, in both packages."""
    seg_dims = jseg.SegmentationDims(d_model=64, n_head=2, n_layer=1)
    emb_dims = jemb.EmbeddingDims(channels=64, n_blocks=1, embed_dim=32)
    seg_params = jseg.init_params(seg_dims, jax.random.PRNGKey(0))
    emb_params = jemb.init_params(emb_dims, jax.random.PRNGKey(1))
    cfg = dict(seg_batch=64, emb_batch=64)
    jd = jdz.SpeakerDiarizer(JDConfig(**cfg), seg_params=seg_params, seg_dims=seg_dims,
                             emb_params=emb_params, emb_dims=emb_dims)
    td = _port_diarizer(DiarizationConfig(**cfg), seg_params, seg_dims, emb_params, emb_dims)
    return jd, td


def test_bucket_shapes_match_jax(monkeypatch, random_nets):
    """Every forward's batch is one of the JAX package's buckets, in the
    same order, and the turns are equal."""
    jd, td = random_nets
    ref_shapes = {"seg": [], "emb": []}

    def recording(kind, fn):
        def call(params, dims, mels):
            ref_shapes[kind].append(tuple(mels.shape))
            return fn(params, dims, mels)
        return call

    monkeypatch.setattr(jdz, "_seg_forward", recording("seg", jseg.forward))
    monkeypatch.setattr(jdz, "_emb_forward", recording("emb", jemb.forward))
    got_shapes = {"seg": [], "emb": []}
    hooks = [m.register_forward_pre_hook(lambda mod, args, k=k: got_shapes[k].append(
        tuple(args[0].shape))) for k, m in (("seg", td.seg_params), ("emb", td.emb_params))]
    try:
        audios = [_speech_like(s, i) for i, s in enumerate((12, 15, 20, 9))]
        ref = jd.process_batch(audios, num_speakers=2)
        got = td.process_batch(audios, num_speakers=2)
    finally:
        for h in hooks:
            h.remove()
    assert got_shapes == ref_shapes
    for kind, cap in (("seg", 64), ("emb", 64)):
        sizes = {s[0] for s in got_shapes[kind]}
        assert len(sizes) <= 2 and all(b & (b - 1) == 0 and b <= cap for b in sizes)
    assert [_turns(g) for g in got] == [_turns(r) for r in ref]


def test_bucket_spans():
    spans = tdz.SpeakerDiarizer._bucket_spans
    for n in (1, 3, 64, 65, 200):
        assert spans(n, 64) == jdz.SpeakerDiarizer._bucket_spans(n, 64)
    assert spans(5, 64) == [(0, 5, 8)]
    assert spans(130, 64) == [(0, 64, 64), (64, 128, 64), (128, 130, 64)]


def test_single_file_equals_batch_row(random_nets):
    _, td = random_nets
    a = _speech_like(14, 3)
    b = _speech_like(9, 4)
    solo = td.process_audio(a, num_speakers=2)
    batch = td.process_batch([a, b], num_speakers=2)[0]
    assert _turns(solo) == _turns(batch)


def test_sliding_windows_cover_whole_file(random_nets):
    _, td = random_nets
    starts = td._seg_window_starts(int(30 * SR))
    assert len(starts) == 21
    assert starts[0] == 0 and starts[-1] == 20 * SR


def test_fallback_path_keeps_turns_inside_file():
    d = tdz.SpeakerDiarizer(DiarizationConfig(), device="cpu")
    audio = np.concatenate([
        _speech_like(4, 0), np.zeros(4 * SR, np.float32), _speech_like(4, 1)])
    segs = d.process_audio(audio, num_speakers=2)
    assert segs, "fallback diarization produced no turns"
    assert all(s.end <= len(audio) / SR + 1 for s in segs)
    assert _turns(segs) == _turns(jdz.SpeakerDiarizer().process_audio(audio, num_speakers=2))


# ---------------------------------------------------------------------------
# Merge, format, smoothing, estimate, powerset (tests/test_diarization.py's cases)


def test_two_speakers_separate():
    audio = _two_speaker_audio(np.random.default_rng(1))
    turns = tdz.SpeakerDiarizer(DiarizationConfig(), device="cpu").process_audio(
        audio, num_speakers=2)
    assert len({t.speaker for t in turns}) == 2

    def label_at(t):
        return next((s.speaker for s in turns if s.start <= t <= s.end), None)

    assert label_at(1.5) == label_at(9.5)
    assert label_at(5.5) == label_at(13.5)
    assert label_at(1.5) != label_at(5.5)


def test_auto_speaker_estimate():
    d = tdz.SpeakerDiarizer(DiarizationConfig(), device="cpu")
    assert d.estimate_num_speakers(np.zeros(10 * SR)) == 2
    assert d.estimate_num_speakers(np.zeros(95 * SR)) == 3
    assert d.estimate_num_speakers(np.zeros(1000 * SR)) == 10  # cap


def test_merge_max_overlap():
    diar = [tdz.DiarizationSegment(0.0, 5.0, "Speaker 0"),
            tdz.DiarizationSegment(5.0, 10.0, "Speaker 1")]
    transcript = [
        {"text": "hello", "start": 0.5, "end": 2.0},
        {"text": "world", "start": 4.0, "end": 6.5},   # 1.0s in spk0, 1.5s in spk1
        {"text": "bye", "start": 8.0, "end": 9.0},
    ]
    merged = tdz.SpeakerDiarizer.create_transcript_with_speakers(transcript, diar)
    assert [m["speaker"] for m in merged] == ["Speaker 0", "Speaker 1", "Speaker 1"]
    assert merged == jdz.SpeakerDiarizer.create_transcript_with_speakers(
        transcript, [jdz.DiarizationSegment(0.0, 5.0, "Speaker 0"),
                     jdz.DiarizationSegment(5.0, 10.0, "Speaker 1")])


def test_merge_alternating_fallback():
    transcript = [{"text": t, "start": i, "end": i + 1} for i, t in enumerate("abcd")]
    merged = tdz.SpeakerDiarizer.create_transcript_with_speakers(transcript, [])
    assert [m["speaker"] for m in merged] == [
        "Speaker 0", "Speaker 1", "Speaker 0", "Speaker 1"]


def test_format_as_conversation_groups_consecutive():
    segs = [{"speaker": "Alice", "text": "hi"}, {"speaker": "Alice", "text": "there"},
            {"speaker": "Bob", "text": "hey"}]
    out = tdz.SpeakerDiarizer.format_as_conversation(segs)
    assert out == "**Alice**: hi there\n\n**Bob**: hey"
    assert out == jdz.SpeakerDiarizer.format_as_conversation(segs)


def test_smoothing_min_durations():
    d = tdz.SpeakerDiarizer(DiarizationConfig(min_duration_on=0.3, min_duration_off=0.5),
                            device="cpu")
    turns = [(0.0, 1.0, 0), (1.2, 2.0, 0), (2.0, 2.1, 1), (3.0, 4.0, 1)]
    sm = d._smooth(turns)
    assert sm[0] == (0.0, 2.0, 0)
    assert (2.0, 2.1, 1) not in sm
    assert (3.0, 4.0, 1) in sm


def test_powerset_decode_and_speech_prob():
    logits = np.full((1, 3, tseg.N_CLASSES), -10.0)
    logits[0, 0, 0] = 0    # ∅
    logits[0, 1, 2] = 0    # {B}
    logits[0, 2, 4] = 0    # {A,B}
    act = tseg.powerset_to_activity(logits)
    assert act[0].tolist() == [[False, False, False], [False, True, False],
                               [True, True, False]]
    p = tseg.powerset_speech_prob(logits)
    assert p[0, 0] < 0.01 and p[0, 1] > 0.99


def test_entry_point_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdz.SpeakerDiarizer()
