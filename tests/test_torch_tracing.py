"""The port's tracer (turbo_whisper_workspace_tpu_torch/utils/profiling.py)
and the spans the program opens with it, on the CPU at tiny sizes: off,
it records nothing; on (under torch.profiler), each span is recorded
with its parent, request and attributes on the profiler's own clock; a
loop's `timings` are its spans' durations; and the transcriber, the
step loop, the pipeline and the LLM stage emit their span trees. One
test repeats the clock check on a card, with CUDA activity traced."""

import threading
import wave
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from turbo_whisper_workspace_tpu_torch.config import PipelineConfig, TranscriptionConfig
from turbo_whisper_workspace_tpu_torch.decode import greedy
from turbo_whisper_workspace_tpu_torch.decode.rules import DecodeRules
from turbo_whisper_workspace_tpu_torch.decode.tokenizer import WhisperTokenizer
from turbo_whisper_workspace_tpu_torch.llm import generate, llm_helper
from turbo_whisper_workspace_tpu_torch.models import llama as lm
from turbo_whisper_workspace_tpu_torch.models import whisper as wm
from turbo_whisper_workspace_tpu_torch.ops import mel as mel_ops
from turbo_whisper_workspace_tpu_torch.pipeline import audio_pipeline, transcriber
from turbo_whisper_workspace_tpu_torch.utils import profiling, step_loop

WDIMS = wm.WhisperDims(80, 1500, 64, 2, 2, 51865, 448, 64, 2, 2)
LDIMS = lm.LlamaDims(n_vocab=300, d_model=64, n_layer=2, n_head=4, n_kv_head=2, d_ff=128)
SR = 16000


@pytest.fixture(scope="module")
def whisper_model():
    return wm.init_params(WDIMS, torch.Generator().manual_seed(0))


@pytest.fixture(autouse=True)
def fresh_spans():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


def traced(fn, *args, **kw):
    """fn(*args, **kw) under a CPU torch.profiler: (its result, the spans,
    the profiler)."""
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn(*args, **kw)
    return out, profiling.spans(), prof


def by_name(spans, name):
    return [s for s in spans if s.name == name]


def children(spans, parent, name=None):
    return [s for s in spans if s.parent == parent.id and (name is None or s.name == name)]


def speech(seconds: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    audio = 0.3 * np.sin(2 * np.pi * 180 * t) + 0.01 * rng.standard_normal(t.size)
    return audio.astype(np.float32)


# ---------------------------------------------------------------------------
# the tracer


def test_off_the_tracer_records_nothing_and_opens_no_record_function(monkeypatch):
    opened = []
    monkeypatch.setattr(profiling, "_annotation", lambda name: opened.append(name))
    with profiling.span("a", rows=3) as s:
        s.set(more=1)
        with profiling.span("b"):
            pass
    assert s is profiling.span("c")           # the one shared no-op
    with profiling.span("timed", timed=True, rows=2) as t:
        pass
    assert t.seconds >= 0 and t.attrs == {"rows": 2}
    assert profiling.spans() == [] and opened == []


def test_a_span_is_recorded_with_its_parent_request_attributes_and_the_profilers_clock():
    def work():
        with profiling.span("outer", files=2) as outer:
            with profiling.span("inner", rows=4) as inner:
                torch.ones(64, 64) @ torch.ones(64, 64)
                inner.set(retried=1)
            outer.set(windows=5)
        with profiling.span("second"):
            pass

    _, spans, prof = traced(work)
    outer, inner, second = by_name(spans, "outer")[0], by_name(spans, "inner")[0], \
        by_name(spans, "second")[0]
    assert [s.name for s in spans] == ["inner", "outer", "second"]     # in the order they end
    assert outer.parent is None and outer.request == outer.id
    assert inner.parent == outer.id and inner.request == outer.id
    assert second.parent is None and second.request == second.id != outer.id
    assert outer.attrs == {"files": 2, "windows": 5} and inner.attrs == {"rows": 4, "retried": 1}
    assert outer.start_ns <= inner.start_ns < inner.end_ns <= outer.end_ns
    # each span's start and end on the clock the profiler stamps its own event with
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    for s in spans:
        e = events[s.name]
        assert abs(e.start_ns() - s.start_ns) < 50_000, s.name
        assert abs(e.start_ns() + e.duration_ns() - s.end_ns) < 50_000, s.name


def test_two_threads_get_two_requests():
    barrier = threading.Barrier(2)

    def caller():
        with profiling.span("call"):
            barrier.wait(timeout=10)
            with profiling.span("step"):
                pass

    def work():
        threads = [threading.Thread(target=caller) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
        assert not any(t.is_alive() for t in threads)

    _, spans, _ = traced(work)
    calls = by_name(spans, "call")
    assert len(calls) == 2 and calls[0].request != calls[1].request
    for c in calls:
        (step,) = children(spans, c, "step")
        assert step.request == c.request


def test_trace_clears_the_record_and_keeps_the_blocks_spans(tmp_path):
    def before():
        with profiling.span("before"):
            pass

    assert [s.name for s in traced(before)[1]] == ["before"]
    with profiling.trace(str(tmp_path)):
        with profiling.span("during"):
            pass
    assert [s.name for s in profiling.spans()] == ["during"]


# ---------------------------------------------------------------------------
# the step loop and the loops' timings


@pytest.mark.parametrize("every,n_steps", [(1, 10), (3, 10), (3, 2)])
def test_an_eager_run_steps_opens_the_loop_and_a_stop_read_per_read(every, n_steps):
    state = {"step": torch.zeros((), dtype=torch.long),
             "finished": torch.zeros(4, dtype=torch.bool)}

    def step():
        state["finished"][min(int(state["step"]), 3)] = True  # row r finishes at step r + 1
        state["step"].add_(1)

    reads = []
    flag_read = step_loop._StopFlag.read

    def counted(self):
        reads.append(1)
        return flag_read(self)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(step_loop._StopFlag, "read", counted)
        done, spans, _ = traced(step_loop.run_steps, step, state, n_steps, every,
                                graphed=False)
    assert done == {(1, 10): 4, (3, 10): 6, (3, 2): 2}[every, n_steps]
    assert by_name(spans, "step_loop.capture") == []
    (loop,) = by_name(spans, "step_loop.loop")
    assert loop.attrs == {"steps": done}
    stops = by_name(spans, "step_loop.stop_read")
    # the loop ends on a read, also where it ran out of steps
    assert len(stops) == len(reads) == 1 + -(-done // every)
    assert stops[-1].end_ns <= loop.end_ns
    # the first read comes before the loop; the rest are the loop's
    assert sum(s.parent == loop.id for s in stops) == len(stops) - 1


def _greedy(model, timings):
    rules = DecodeRules(specials=WhisperTokenizer.for_model(WDIMS.n_vocab).specials)
    audio = torch.from_numpy(np.clip(speech(30.0, 1) * 32768, -32768, 32767).astype(np.int16))
    cross = model.decoder.precompute_cross_kv(
        model.encoder(mel_ops.log_mel_spectrogram(audio[None], num_mels=80)))
    prompt = torch.tensor([rules.specials.sot_sequence(language="en")])
    return greedy.greedy_decode_features(model, cross, prompt, rules=rules, max_len=6,
                                         timings=timings)


def _generate(_, timings):
    params = lm.init_params(LDIMS, torch.Generator().manual_seed(0))
    prompt = torch.arange(1, 10)[None]
    return generate.generate_tokens(params, LDIMS, prompt, max_len=6, timings=timings)


@pytest.mark.parametrize("loop,spanned", [
    (_greedy, {"loop_s": "step_loop.loop"}),
    (_generate, {"loop_s": "step_loop.loop", "prefill_s": "llm.prefill"}),
], ids=["greedy", "generate"])
def test_timings_hold_the_same_with_the_profiler_off_and_on(whisper_model, loop, spanned):
    off, on = {}, {}
    res_off = loop(whisper_model, off)
    res_on, spans, _ = traced(loop, whisper_model, on)
    assert sorted(on) == sorted(off)
    assert on["decode_forwards"] == off["decode_forwards"] and on["capture_s"] == 0.0
    assert torch.equal(res_on.tokens, res_off.tokens)
    assert all(off[k] > 0 for k in spanned)
    # with the profiler on, each interval is its span's own duration
    for key, name in spanned.items():
        (s,) = by_name(spans, name)
        assert on[key] == (s.end_ns - s.start_ns) / 1e9
    if loop is _greedy:
        (pre,) = by_name(spans, "greedy.prefill")
        (loop_span,) = by_name(spans, "step_loop.loop")
        assert pre.end_ns <= loop_span.start_ns


# ---------------------------------------------------------------------------
# the transcriber and the pipeline


def test_the_transcriber_emits_its_span_tree(whisper_model):
    tr = transcriber.load_transcriber(
        whisper_model, TranscriptionConfig(batch_size=4, max_decode_len=4), device="cpu")
    audios = [speech(50.0, 2), speech(10.0, 3), speech(8.0, 4)]
    rows = []                    # the rows of each greedy decode, as the benchmark counts them
    decode = greedy.greedy_decode_features

    def counted(model, cross_kv, prompt, **kw):
        rows.append(prompt.shape[0])
        return decode(model, cross_kv, prompt, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(greedy, "greedy_decode_features", counted)
        out, spans, _ = traced(tr.transcribe, audios)
    assert len(out) == 3
    (call,) = by_name(spans, "transcriber.transcribe")
    windows = tr.last_n_windows
    assert windows == 4 and call.parent is None
    assert call.attrs == {"windows": windows}
    assert all(s.request == call.request for s in spans)
    kids = [s.name for s in sorted(children(spans, call), key=lambda s: s.start_ns)]
    temps = transcriber.FALLBACK_TEMPERATURES
    assert kids == (["transcriber.plan", "transcriber.encode", "transcriber.detect"]
                    + ["transcriber.decode", "transcriber.postprocess"] * len(temps)
                    + ["transcriber.merge"])
    assert all(s.attrs == {} for s in spans if s.name.startswith("transcriber.")
               and s is not call)
    decodes = by_name(spans, "transcriber.decode")
    # random weights: every window is retried at each temperature, one
    # greedy decode of all its rows inside each decode span
    assert rows == [windows] * len(decodes) == [windows] * len(temps)
    assert sum(rows) / windows == len(decodes)          # decodes_per_window's count
    for d in decodes:
        inside = [s.name for s in spans if d.start_ns <= s.start_ns and s.end_ns <= d.end_ns
                  and s is not d]
        assert inside.count("greedy.prefill") == inside.count("step_loop.loop") == 1
    assert len(by_name(spans, "step_loop.loop")) == len(temps)


def test_a_request_reads_its_file_under_the_pipeline_span(whisper_model, tmp_path):
    path = str(tmp_path / "request.wav")
    pcm = (speech(12.0, 5) * 32767).astype("<i2")
    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(SR)
        f.writeframes(pcm.tobytes())
    tr = transcriber.load_transcriber(
        whisper_model, TranscriptionConfig(max_decode_len=3, language="en"), device="cpu")
    pipe = audio_pipeline.AudioProcessingPipeline(
        PipelineConfig(transcription=tr.config), transcriber=tr, device="cpu")
    out, spans, _ = traced(pipe.transcribe, path)
    assert "segments" in out
    (req,) = by_name(spans, "pipeline.transcribe")
    (read,) = children(spans, req, "audio.read")
    (call,) = children(spans, req, "transcriber.transcribe")
    assert req.parent is None and req.attrs == read.attrs == {}
    assert call.request == read.request == req.id
    assert by_name(spans, "transcriber.detect") == []      # the language is pinned


def test_an_llm_stage_spans_its_generation(monkeypatch):
    params = lm.init_params(LDIMS, torch.Generator().manual_seed(0))
    llm = llm_helper.TorchLlama(params, LDIMS, device="cpu")
    monkeypatch.setattr(llm_helper, "_llm_instance", llm)
    monkeypatch.setattr(llm_helper, "_schedule_unload", lambda: None)
    pipe = audio_pipeline.AudioProcessingPipeline(PipelineConfig(), device="cpu")
    segments = [{"speaker": "SPEAKER_00", "start": 0.0, "end": 2.0, "text": "hello there"},
                {"speaker": "SPEAKER_01", "start": 2.0, "end": 4.0, "text": "hi, I am Anna"}]
    monkeypatch.setattr(pipe.config.llm, "max_tokens_summary", 3)
    _, spans, _ = traced(pipe.generate_summary, segments)
    (stage,) = by_name(spans, "llm.stage")
    (gen,) = children(spans, stage, "llm.generate")
    assert stage.parent is None and stage.attrs == gen.attrs == {}
    (pre,) = children(spans, gen, "llm.prefill")
    assert llm.last_generation["prefill_s"] == (pre.end_ns - pre.start_ns) / 1e9
    assert [s.parent for s in by_name(spans, "step_loop.loop")] == [gen.id]
    assert all(s.request == stage.id for s in spans)


# ---------------------------------------------------------------------------
# on a card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run tests/test_torch_tracing.py on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_on_a_card_spans_keep_the_profilers_clock(cuda_device):
    x = torch.randn(2048, 2048, device=cuda_device)

    def work():
        with profiling.span("outer"):
            with profiling.span("matmuls"):
                for _ in range(8):
                    x @ x
            torch.cuda.synchronize()

    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        work()
    spans = profiling.spans()
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.device_type() != torch.autograd.DeviceType.CUDA}
    for s in spans:
        e = events[s.name]
        assert abs(e.start_ns() - s.start_ns) < 50_000, s.name
        assert abs(e.start_ns() + e.duration_ns() - s.end_ns) < 50_000, s.name
    assert sorted(s.name for s in spans) == ["matmuls", "outer"]
