"""The reference against the port at tiny sizes on the CPU, and the
controls at a size a test run holds: a lower precision reads further
from the reference than the port does."""

import numpy as np
import pytest
import torch

from port_bench.lib import asr, spec, traffic, weights
from port_bench.reference import llama as ref_llama
from port_bench.reference import whisper as ref
from port_bench.tests import tiny

SEED = 2**31 + 99


@pytest.fixture(scope="module")
def audio():
    params = spec.traffic("batch-32win")["speech"]
    x = traffic.speech(45 * traffic.SAMPLE_RATE, params, torch.Generator().manual_seed(1), "cpu")
    return np.stack([ref.window(x, s) for s in traffic.window_starts(len(x))])


@pytest.fixture(scope="module")
def port_whisper():
    """The port's Whisper with the benchmark's weights, in f32 on the CPU."""
    model = asr.build_model(tiny.WHISPER, SEED, "cpu").float()
    return model


def test_log_mel_matches_the_port(audio):
    from turbo_whisper_workspace_tpu_torch.ops import mel

    pcm = torch.from_numpy(ref.to_pcm(audio))
    ours = ref.log_mel(pcm, 128)
    theirs = mel.log_mel_spectrogram(pcm, num_mels=128)
    assert ours.shape == theirs.shape == (2, 128, 3000)
    torch.testing.assert_close(ours, theirs, atol=2e-4, rtol=0)


def test_encoder_cross_kv_and_decoder_match_the_port(audio, port_whisper):
    from turbo_whisper_workspace_tpu_torch.ops import mel

    model = ref.Whisper(tiny.WHISPER, weights.whisper_state(tiny.WHISPER, SEED, "cpu"), "cpu")
    pcm = torch.from_numpy(ref.to_pcm(audio))
    m = mel.log_mel_spectrogram(pcm, num_mels=128)
    with torch.no_grad():
        feats = port_whisper.encoder(m)
        # the port's positions are the sinusoids rounded to bf16, the reference's exact
        torch.testing.assert_close(model.encode(m), feats, atol=1e-2, rtol=0)
        cross_port = port_whisper.decoder.precompute_cross_kv(feats, quantize=True)
        tokens = torch.tensor([[50258, 50259, 50360, 50365, 440, 50400, 50401, 1000]] * 2)
        theirs = port_whisper.decoder(tokens, cross_port)[0]
        ours = model.decode(tokens, model.cross_kv(feats))
    torch.testing.assert_close(ours, theirs, atol=2e-3, rtol=0)


def test_grammar_masks():
    sp = ref.Specials(51866)
    tb = sp.timestamp_begin
    served = [tb + 10, 440, 220, tb + 30, tb + 30, 500, sp.eot]
    ok = ref.allowed_masks(sp, served, "cpu")
    assert ok[0, tb:tb + 51].all() and not ok[0, :tb].any() and not ok[0, tb + 51:].any()
    assert not ok[1, tb:].any()                     # ts then the sentinel: text must follow
    assert ok[2, :sp.eot].any() and not ok[2, tb:tb + 10].any() and ok[2, tb + 11]
    assert not ok[4, :sp.eot].any() and not ok[4, tb:tb + 30].any() and ok[4, tb + 30]
    assert not ok[5, tb:].any()                     # a pair of timestamps: text follows
    assert not ok[6, tb:tb + 31].any() and ok[6, tb + 31]
    assert not ok[:, sp.sot].any() and not ok[:, list(sp.languages)].any()


def test_served_greedy_tokens_read_near_zero(audio, port_whisper):
    """The port's own greedy decode on the CPU, judged by the check."""
    from turbo_whisper_workspace_tpu_torch.config import TranscriptionConfig
    from turbo_whisper_workspace_tpu_torch.pipeline.transcriber import load_transcriber

    tr = load_transcriber(port_whisper, TranscriptionConfig(max_decode_len=12), device="cpu")
    tap = asr.DecodeTap(tracing=False)
    try:
        tr.transcribe([a for a in audio])
        res = tap.take()[0]
    finally:
        tap.close()
    samples = [{"audio": audio[i], "tokens": res.tokens[i].tolist(), "prompt": 3,
                "n": int(res.lengths[i]), "avg_logprob": float(res.avg_logprobs[i]),
                "first": True} for i in range(2)]
    limits = {"logprob_gap": 1.0, "token_gap": 1.0}
    port_lp, port = asr.check(tiny.WHISPER, SEED, "cpu", samples, limits)
    ctl_lp, ctl = asr.check(tiny.WHISPER, SEED, "cpu", samples, limits, control="fp8")
    wrong_lp, wrong = asr.check(tiny.WHISPER, SEED, "cpu", samples, limits,
                                control="second_best")
    assert port["tokens"] == ctl["tokens"] == wrong["tokens"] >= 10
    assert port["value"] < 2e-3
    assert ctl["value"] > 5 * max(port["value"], 1e-3)
    # the mean log-probability of the served tokens: the port's against the reference's
    assert port_lp["value"] < 1e-3
    assert ctl_lp["value"] > 5 * port_lp["value"]
    # a wrong argmax reported with its own log-probability: the mean does
    # not see it, the widest token gap does
    assert wrong_lp["value"] < 1e-6
    assert wrong["value"] > 5 * max(port["value"], 1e-3)


def test_llama_reference_matches_the_ports_prefill_and_decode():
    from turbo_whisper_workspace_tpu_torch.llm import generate
    from port_bench.entries import llm_enrich

    cfg = tiny.LLAMA
    params = llm_enrich.build_params(cfg, SEED, "cpu")
    dims = llm_enrich.dims(cfg)
    prompt = torch.randint(0, 256, (1, 40), generator=torch.Generator().manual_seed(3))
    res = generate.generate_tokens(params, dims, prompt, max_len=8, temperature=0.0)
    tokens = res.tokens[0].tolist()
    logits = ref_llama.served_logits(cfg, SEED, [(tokens, 40)], "cpu")[0]
    served = torch.tensor(tokens[40:])
    rows = logits[:len(served)]
    gap = float((rows.amax(-1) - rows.gather(-1, served[:, None])[:, 0]).max())
    assert gap < 2e-2
    port = llm_enrich.check(cfg, SEED, "cpu", [(tokens, 40)], {"mean_gap": 1.0})[0]
    control = llm_enrich.check(cfg, SEED, "cpu", [(tokens, 40)], {"mean_gap": 1.0},
                               control="int4_activations")[0]
    assert port["max"] == pytest.approx(gap)
    assert control["max"] > gap and control["value"] > port["value"]


def test_a_timestamp_rule_near_tie_reads_its_margin():
    """The forcing rule on a near-tie: served either way, the gap is the
    reference's margin, not the distance to the other decision's best."""
    sp = ref.Specials(51866)
    tb = sp.timestamp_begin
    served = [tb + 10, 440, tb + 12]                 # ts, text, then a timestamp
    allowed = ref.allowed_masks(sp, served, "cpu")
    logits = torch.full((3, 51866), -50.0)
    logits[:, 440] = 3.0                            # the best text token
    logits[2, tb + 12] = 3.0 - 0.01                 # ts_lse just under max_text: no force
    logits[0, tb + 10] = 4.0
    logits[1, 440] = 6.0
    gaps = ref.token_gaps(logits, served, allowed, tb)
    assert gaps[0] == 0 and gaps[1] == 0
    assert 0 < gaps[2] < 0.05                        # the margin, not 3.0 - 2.99 + the force flip
    served_text = [tb + 10, 440, 440]
    logits[2, tb + 12] = 3.0 + 0.01                 # now the rule forces a timestamp
    gaps = ref.token_gaps(logits, served_text, ref.allowed_masks(sp, served_text, "cpu"), tb)
    assert 0 < gaps[2] < 0.05
    logits[2, tb + 12] = 5.0                        # forced by a wide margin: a text token is wrong
    gaps = ref.token_gaps(logits, served_text, ref.allowed_masks(sp, served_text, "cpu"), tb)
    assert gaps[2] > 1.5
