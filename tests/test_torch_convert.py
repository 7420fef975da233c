"""Port HF Whisper snapshot loading (turbo_whisper_workspace_tpu_torch/
models/convert.py: hf_config_from_dims, dims_from_hf_config,
params_from_hf_state_dict, load_hf_snapshot; pipeline/audio_pipeline.py:
load_transcription_model; the CLI's `convert`) against the JAX package,
on a random-init tiny transformers WhisperForConditionalGeneration saved
with `save_pretrained`; and the port's own checkpoints (save_checkpoint /
load_checkpoint) and models/whisper.py:param_count."""

import json
import logging

import jax
import numpy as np
import pytest
import torch

from turbo_whisper_workspace_tpu.config import PipelineConfig as JPipelineConfig
from turbo_whisper_workspace_tpu.config import TranscriptionConfig as JConfig
from turbo_whisper_workspace_tpu.models import convert as jconvert
from turbo_whisper_workspace_tpu.models import whisper as jwm
from turbo_whisper_workspace_tpu.pipeline import audio_pipeline as jpipe
from turbo_whisper_workspace_tpu.pipeline import transcriber as jtr
from turbo_whisper_workspace_tpu_torch.config import PipelineConfig
from turbo_whisper_workspace_tpu_torch.config import TranscriptionConfig as TConfig
from turbo_whisper_workspace_tpu_torch.models import convert as tconvert
from turbo_whisper_workspace_tpu_torch.models import whisper as twm
from turbo_whisper_workspace_tpu_torch.pipeline import audio_pipeline as tpipe
from turbo_whisper_workspace_tpu_torch.pipeline import transcriber as ttr

transformers = pytest.importorskip("transformers")

# tiny widths, the real vocabulary (the transcriber's special tokens)
DIMS = jwm.WhisperDims(80, 1500, 64, 2, 2, 51865, 448, 64, 2, 2)
NAME = "tiny-snapshot"           # not in either package's WHISPER_CONFIGS


def save_snapshot(path, safe: bool = True) -> None:
    torch.manual_seed(0)
    model = transformers.WhisperForConditionalGeneration(jconvert.hf_config_from_dims(DIMS))
    model.save_pretrained(str(path), safe_serialization=safe)


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    path = tmp_path_factory.mktemp("models") / f"whisper-{NAME}"
    save_snapshot(path)
    return path


def test_name_is_unlisted():
    assert NAME not in jwm.WHISPER_CONFIGS and NAME not in twm.WHISPER_CONFIGS


@pytest.mark.parametrize("drop", [(), ("num_mel_bins", "decoder_layers", "vocab_size")])
def test_dims_from_hf_config_matches_jax(snapshot, drop):
    """The config.json mapping, whole or with keys left to the
    WhisperConfig defaults."""
    raw = json.loads((snapshot / "config.json").read_text())
    raw = {k: v for k, v in raw.items() if k not in drop}
    ref = jconvert.dims_from_hf_config(transformers.WhisperConfig(**raw))
    assert tconvert.dims_from_hf_config(raw) == twm.WhisperDims(**ref.__dict__)


@pytest.mark.parametrize("safe", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_load_hf_snapshot_matches_jax(tmp_path, safe, dtype):
    """model.safetensors or pytorch_model.bin: every weight of the port's
    model equals the JAX loader's leaf, compared in f32."""
    path = tmp_path / f"whisper-{NAME}"
    save_snapshot(path, safe=safe)
    ref, jdims = jconvert.load_hf_snapshot(str(path), dtype=getattr(jax.numpy, dtype))
    model, dims = tconvert.load_hf_snapshot(str(path), dtype=getattr(torch, dtype))
    assert dims == twm.WhisperDims(**jdims.__dict__) == model.dims
    want = tconvert.state_dict_from_jax_params(jax.tree.map(np.asarray, ref))
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for name, val in got.items():
        assert val.dtype == getattr(torch, dtype), name
        np.testing.assert_array_equal(val.float().numpy(), want[name].numpy(), err_msg=name)


def test_params_from_hf_state_dict_takes_both_key_styles(snapshot):
    """"model.encoder..." (the full model) and "encoder..." (its inner
    WhisperModel) keys give the same weights."""
    torch.manual_seed(0)
    hf = transformers.WhisperForConditionalGeneration(jconvert.hf_config_from_dims(DIMS))
    dims = twm.WhisperDims(**DIMS.__dict__)
    a = tconvert.params_from_hf_state_dict(hf.state_dict(), dims).state_dict()
    b = tconvert.params_from_hf_state_dict(hf.model.state_dict(), dims).state_dict()
    assert sorted(a) == sorted(b)
    for name in a:
        torch.testing.assert_close(a[name], b[name], rtol=0, atol=0)


def test_missing_weights_raise(tmp_path):
    (tmp_path / "config.json").write_text(json.dumps({"d_model": 64}))
    with pytest.raises(FileNotFoundError):
        tconvert.load_hf_snapshot(str(tmp_path))


def test_pipeline_loads_snapshot_under_unlisted_name(snapshot, monkeypatch, caplog):
    """A models_dir holding only the snapshot: the port's pipeline loads
    it (no random-init warning) with the dims of its config.json, and
    transcribes the golden clip to the JAX pipeline's tokens."""
    import pathlib

    golden = pathlib.Path(__file__).resolve().parent.parent / "examples" / "golden"
    clip = str(golden / "conversation.wav")
    monkeypatch.setattr(jtr, "FALLBACK_TEMPERATURES", (0.0,))
    monkeypatch.setattr(ttr, "FALLBACK_TEMPERATURES", (0.0,))
    models_dir = str(snapshot.parent)
    kw = dict(model=NAME, max_decode_len=8, batch_size=1)
    jp = jpipe.AudioProcessingPipeline(JPipelineConfig(models_dir=models_dir,
                                                       transcription=JConfig(**kw)))
    tp = tpipe.AudioProcessingPipeline(PipelineConfig(models_dir=models_dir,
                                                      transcription=TConfig(**kw)),
                                       device="cpu")
    with caplog.at_level(logging.WARNING):
        tt = tp.load_transcription_model()
    assert not [r for r in caplog.records if "random init" in r.getMessage()]
    assert not [r for r in caplog.records if "load failed" in r.getMessage()]
    assert tt.model.dims == twm.WhisperDims(**DIMS.__dict__)
    assert next(tt.model.parameters()).dtype == torch.bfloat16
    ref = jp.transcribe(clip)
    got = tp.transcribe(clip)
    assert got["language"] == ref["language"]
    assert got["chunks"] == ref["chunks"]
    assert [(s["text"], s["start"], s["end"]) for s in got["segments"]] == \
        [(s["text"], s["start"], s["end"]) for s in ref["segments"]]


def test_pipeline_raises_for_unlisted_name_without_snapshot(tmp_path):
    pipe = tpipe.AudioProcessingPipeline(
        PipelineConfig(models_dir=str(tmp_path), transcription=TConfig(model=NAME)),
        device="cpu")
    with pytest.raises(ValueError, match="unknown whisper model"):
        pipe.load_transcription_model()


def test_hf_config_from_dims_matches_jax():
    dims = twm.WhisperDims(**DIMS.__dict__)
    assert tconvert.hf_config_from_dims(dims).to_dict() == \
        jconvert.hf_config_from_dims(DIMS).to_dict()


@pytest.mark.parametrize("name", ["tiny", "large-v3-turbo"])
def test_param_count_matches_jax(name):
    """The count from the dims alone (a meta-device model: no weights
    are allocated), against JAX param_count over the shapes of its init."""
    jdims = DIMS if name == "tiny" else jwm.WHISPER_CONFIGS[name]
    shapes = jax.eval_shape(lambda: jwm.init_params(jdims, jax.random.PRNGKey(0)))
    with torch.device("meta"):
        model = twm.Whisper(twm.WhisperDims(**jdims.__dict__))
    assert twm.param_count(model) == jwm.param_count(shapes)


def test_checkpoint_round_trip(tmp_path):
    """A module's state dict and a nested numpy tree, saved and loaded
    back: equal leaves; `like` gives each leaf its dtype."""
    gen = torch.Generator().manual_seed(0)
    model = twm.init_params(twm.WhisperDims(**DIMS.__dict__), gen)
    path = str(tmp_path / "ckpt" / "whisper.pt")
    tconvert.save_checkpoint(path, model)
    back = tconvert.load_checkpoint(path)
    assert sorted(back) == sorted(model.state_dict())
    for name, val in model.state_dict().items():
        assert torch.equal(back[name], val), name
    like = {k: v.to(torch.bfloat16) for k, v in model.state_dict().items()}
    cast = tconvert.load_checkpoint(path, like=like)
    assert all(cast[k].dtype == torch.bfloat16 for k in cast)
    assert torch.equal(cast["decoder.token_emb"], like["decoder.token_emb"])

    tree = {"a": {"w": np.arange(6, dtype=np.float32).reshape(2, 3)},
            "n": np.array([1, 2], np.int32)}
    tconvert.save_checkpoint(str(tmp_path / "tree.pt"), tree)
    back = tconvert.load_checkpoint(str(tmp_path / "tree.pt"))
    np.testing.assert_array_equal(back["a"]["w"].numpy(), tree["a"]["w"])
    assert back["n"].dtype == torch.int32


def test_cli_convert_loads_in_jax(snapshot, tmp_path, capsys):
    """The port's `convert` writes an `.npz` that the JAX package's
    load_params reads, equal leaf by leaf to the JAX package's own
    conversion of the same snapshot."""
    from turbo_whisper_workspace_tpu_torch import __main__ as tcli

    out = str(tmp_path / "whisper-tiny-snapshot.npz")
    tcli.main(["convert", "-i", str(snapshot), "-o", out])
    assert "converted" in capsys.readouterr().out
    got = jconvert.load_params(out, dtype=jax.numpy.float32)
    ref, _ = jconvert.load_hf_snapshot(str(snapshot), dtype=jax.numpy.float32)
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    flat_ref = dict(jax.tree_util.tree_flatten_with_path(ref)[0])
    assert sorted(map(str, flat_got)) == sorted(map(str, flat_ref))
    for key, val in flat_ref.items():
        np.testing.assert_array_equal(np.asarray(flat_got[key]), np.asarray(val),
                                      err_msg=str(key))
