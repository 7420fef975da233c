"""The traffic generator: deterministic by seed, and each mix meets its
parameters."""

import math

import numpy as np
import pytest
import torch

from port_bench.lib import spec, traffic

SR = traffic.SAMPLE_RATE


@pytest.mark.parametrize("seconds", [0.5, 29.99, 30.0, 30.01, 50.0, 50.01, 70.0, 333.3, 600.0])
def test_window_arithmetic_matches_the_ports_plan(seconds):
    from turbo_whisper_workspace_tpu_torch.decode import longform

    n = int(seconds * SR)
    assert traffic.window_starts(n) == [p.start for p in longform.plan_chunks(n)]


@pytest.mark.parametrize("w", [1, 2, 3, 7, 32])
def test_samples_for_windows_is_the_longest_file_of_w_windows(w):
    n = traffic.samples_for_windows(w)
    assert traffic.n_windows(n) == w
    assert traffic.n_windows(n + 1) == w + 1


def test_batch_calls_fill_one_bucket_exactly_and_repeat():
    mix = spec.traffic("batch-32win")
    calls = traffic.batch_calls(mix)
    assert calls == traffic.batch_calls(mix)
    assert len(calls) == mix["pool_calls"]
    lo, hi = mix["file_seconds"]
    for files in calls:
        assert sum(traffic.n_windows(n) for n in files) == mix["windows_per_call"]
        assert all(n <= hi * SR for n in files)
        assert all(n >= lo * SR for n in files[:-1])       # the last one may be cut


def test_request_lengths_cover_the_range_in_a_fixed_set():
    mix = spec.traffic("requests-5-120s")
    lengths = traffic.request_lengths(mix)
    assert lengths == traffic.request_lengths(mix)
    lo, hi = mix["file_seconds"]
    assert len(lengths) == mix["pool_calls"]
    assert all(lo * SR <= n <= hi * SR for n in lengths)
    # stratified: one length in each of pool_calls equal slices of log-length
    slots = sorted(int(len(lengths) * (math.log(n / SR) - math.log(lo))
                       / (math.log(hi) - math.log(lo))) for n in lengths)
    assert slots == list(range(len(lengths)))
    assert {traffic.n_windows(n) for n in lengths} <= {1, 2, 3, 4, 5, 6}


def test_cycle_order_is_a_permutation_by_seed():
    a = traffic.cycle_order(24, 2**31 + 7)
    assert sorted(a) == list(range(24))
    assert a == traffic.cycle_order(24, 2**31 + 7)
    assert a != traffic.cycle_order(24, 2**31 + 8)


def speech(seed, n):
    params = spec.traffic("batch-32win")["speech"]
    return traffic.speech(n, params, torch.Generator().manual_seed(seed), "cpu")


def test_speech_is_deterministic_by_seed_and_never_silent():
    n = 20 * SR
    a, b, c = speech(1, n), speech(1, n), speech(2, n)
    assert a.dtype == np.float32 and a.shape == (n,)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert np.abs(a).max() <= 1.0
    # every 100 ms frame within 40 dB of the peak: the port's VAD gates nothing
    frames = a[: n // 1600 * 1600].reshape(-1, 1600)
    rms = np.sqrt((frames ** 2).mean(-1))
    assert (20 * np.log10(rms / np.abs(a).max()) > -40).all()


def test_speech_keeps_no_window_out_of_the_ports_plan():
    from turbo_whisper_workspace_tpu_torch.decode import longform
    from turbo_whisper_workspace_tpu_torch.pipeline.diarizer import FRAME_HZ, energy_vad

    audio = speech(3, 75 * SR)
    plans = longform.plan_chunks(len(audio))
    assert longform.gate_plans_by_vad(plans, energy_vad(audio), frame_hz=FRAME_HZ) == plans


class Prompts:
    """A stand-in model that records each prompt's byte-token count."""

    is_dummy = False

    def __init__(self):
        self.lengths = []

    def generate(self, prompt, max_tokens=256, temperature=0.1, stop=()):
        self.lengths.append(len(prompt.encode("utf-8")))
        return ""


def test_conversations_give_prompts_of_1200_to_1800_byte_tokens():
    from turbo_whisper_workspace_tpu_torch.config import LLMConfig
    from turbo_whisper_workspace_tpu_torch.llm import llm_helper

    mix = spec.traffic("enrich-20seg")
    sizes = traffic.conversation_sizes(mix)
    assert sizes == traffic.conversation_sizes(mix)
    cfg = LLMConfig(**mix["llm"])
    for seed in (1, 2**31 + 5):
        rng = np.random.default_rng([seed, 1000])
        for lengths in sizes:
            segs = traffic.conversation(lengths, rng)
            assert len(segs) == mix["segments"] == cfg.max_segments
            assert [len(s["text"]) for s in segs] == lengths
            assert {s["speaker"] for s in segs} == {"Speaker 0", "Speaker 1"}
            llm = Prompts()
            llm_helper.identify_speaker_names_llm(segs, llm=llm, config=cfg)
            llm_helper.summarize_conversation(segs, llm=llm, config=cfg)
            llm_helper.extract_topics(segs, llm=llm, config=cfg)
            assert len(llm.lengths) == 3
            assert all(1200 <= n <= 1800 for n in llm.lengths), llm.lengths


def test_conversation_words_follow_the_seed_and_sizes_do_not():
    lengths = [40, 60, 33]
    a = traffic.conversation(lengths, np.random.default_rng([1, 1000]))
    b = traffic.conversation(lengths, np.random.default_rng([1, 1000]))
    c = traffic.conversation(lengths, np.random.default_rng([2, 1000]))
    assert a == b
    assert [s["text"] for s in a] != [s["text"] for s in c]
    assert [len(s["text"]) for s in c] == lengths
