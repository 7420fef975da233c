"""What the two ASR entries share: the port's Whisper built from the
benchmark's weights, the tap on its greedy decode, the traced run's
spans, and the comparison with the reference that decides `correct`.

The tap wraps the port's `decode/greedy.greedy_decode_features` (the
transcriber calls it through its module, once a batch and temperature)
and keeps each call's temperature-0 results: greedy tokens and their
log-probabilities, what a comparison with the reference can judge. With
random weights no
window passes openai/whisper's quality thresholds at T = 0, so the
served text is the T = 1.0 retry's; the T = 0 decode of every window is
still the timed path's work, at the timed batch, and is what is judged.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from . import costs, gaps, traffic, weights
from ..reference import whisper as ref


def dims(cfg: dict):
    from turbo_whisper_workspace_tpu_torch.models.whisper import WhisperDims

    return WhisperDims(
        n_mels=cfg["num_mel_bins"], n_audio_ctx=cfg["max_source_positions"],
        n_audio_state=cfg["d_model"], n_audio_head=cfg["encoder_attention_heads"],
        n_audio_layer=cfg["encoder_layers"], n_vocab=cfg["vocab_size"],
        n_text_ctx=cfg["max_target_positions"], n_text_state=cfg["d_model"],
        n_text_head=cfg["decoder_attention_heads"], n_text_layer=cfg["decoder_layers"])


def build_model(cfg: dict, seed: int, device):
    """The port's Whisper with the benchmark's weights (assigned, not copied)."""
    from turbo_whisper_workspace_tpu_torch.models import whisper as wm

    if cfg["encoder_ffn_dim"] != 4 * cfg["d_model"] or cfg["decoder_ffn_dim"] != 4 * cfg["d_model"]:
        raise ValueError("the port's Whisper blocks have an MLP of 4 × d_model")
    with torch.device("meta"):
        model = wm.Whisper(dims(cfg))
    model.load_state_dict(weights.whisper_state(cfg, seed, device), strict=True, assign=True)
    return model.eval().requires_grad_(False)


def transcriber(cfg: dict, mix: dict, seed: int, device):
    from turbo_whisper_workspace_tpu_torch.config import TranscriptionConfig
    from turbo_whisper_workspace_tpu_torch.pipeline.transcriber import load_transcriber

    return load_transcriber(build_model(cfg, seed, device),
                            TranscriptionConfig(**mix.get("transcription", {})), device=device)


class Span:
    """A device-time span: CUDA events on a card (read after a sync), the
    host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.a = torch.cuda.Event(enable_timing=True)
            self.b = torch.cuda.Event(enable_timing=True)

    def __enter__(self):
        if self.cuda:
            self.a.record()
        else:
            self.t = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            self.b.record()
        else:
            self.t = time.perf_counter() - self.t

    @property
    def ms(self) -> float:
        return self.a.elapsed_time(self.b) if self.cuda else 1e3 * self.t


class DecodeTap:
    """Wraps the port's greedy decode for the life of a run: keeps the
    temperature-0 results of the current call; when tracing, also times
    each decode with CUDA events and reads its steps from the loop's
    `timings`."""

    def __init__(self, tracing: bool):
        from turbo_whisper_workspace_tpu_torch.decode import greedy

        self.module, self.original = greedy, greedy.greedy_decode_features
        self.tracing = tracing
        self.current: list = []           # T = 0 DecodeResults of the call running
        self.spans: list = []             # (Span, steps, rows, prompt)
        greedy.greedy_decode_features = self._decode

    def _decode(self, model, cross_kv, prompt, **kw):
        if not self.tracing:
            res = self.original(model, cross_kv, prompt, **kw)
        else:
            kw.setdefault("timings", {})
            with torch.profiler.record_function("port_bench.greedy_decode"), \
                    Span(prompt.device) as span:
                res = self.original(model, cross_kv, prompt, **kw)
            self.spans.append((span, kw["timings"]["decode_forwards"], prompt.shape[0],
                               prompt.shape[1]))
        if kw.get("temperature", 0.0) == 0.0:
            self.current.append(res)
        return res

    def take(self) -> list:
        out, self.current = self.current, []
        return out

    def close(self) -> None:
        self.module.greedy_decode_features = self.original


class Instruments:
    """A traced run's spans around the port's transcriber."""

    def __init__(self, tr):
        self.tr = tr
        self.encode_spans: list = []     # (Span, windows)
        encode = tr._encode_windows

        def timed_encode(audio_batch):
            with torch.profiler.record_function("port_bench.encode"), \
                    Span(tr.device) as span:
                out = encode(audio_batch)
            self.encode_spans.append((span, audio_batch.shape[0]))
            return out

        tr._encode_windows = timed_encode
        segments = tr._window_segments

        def timed_segments(tokens):
            with torch.profiler.record_function("port_bench.window_text"):
                return segments(tokens)

        tr._window_segments = timed_segments

    def close(self) -> None:
        for name in ("_encode_windows", "_window_segments"):
            self.tr.__dict__.pop(name, None)


def encode_ms_per_window(inst: Instruments) -> float | None:
    spans = inst.encode_spans
    if not spans:
        return None
    return sum(s.ms for s, _ in spans) / sum(n for _, n in spans)


def decode_ms_per_step(tap: DecodeTap) -> float | None:
    steps = sum(s[1] for s in tap.spans)
    if not steps:
        return None
    return sum(s[0].ms for s in tap.spans) / steps


def call_flops(cfg: dict, windows: int, decodes: list) -> float:
    """Model FLOPs of one transcribe call: every window encoded, its
    cross-K/V, language detection, and each decode of its real rows.
    decodes: (steps run, prompt length, rows) of each decode of the call; the
    rows a decode takes past the call's windows (a bucket's padding) are
    not counted, and every window is decoded at each temperature (with
    random weights none passes a threshold early)."""
    sp = ref.Specials(cfg["vocab_size"])
    per_window = (costs.whisper_encoder_flops(cfg) + costs.whisper_cross_kv_flops(cfg)
                  + costs.whisper_detect_flops(cfg, sp.n_languages))
    dec = sum(costs.whisper_decode_flops(cfg, p, n) for n, p, _ in decodes)
    return windows * (per_window + dec)


# ---------------------------------------------------------------------------
# the check


def check(cfg: dict, seed: int, device, samples: list[dict], limits: dict,
          control: str | None = None) -> list[dict]:
    """The two numbers compared, each with its limit from `limits`:

    * `logprob_gap`: over the sampled windows, the largest difference
      between the mean log-probability the program reported for its
      served tokens (`DecodeResult.avg_logprobs`, what the fallback
      thresholds read) and the reference's for the same tokens;
    * `token_gap`: the widest gap, over every served token of the sampled
      windows (and each file's detected language), by which the
      reference's best token beats the served one (`ref.token_gaps`).

    A wrong token reported with its own log-probability reads 0 on the
    first and shows on the second; a log-probability off across a window
    whose tokens stay the best shows on the first.

    samples: {"audio": float window (480000,), "tokens": prompt + sampled
    row, "prompt": P, "n": sampled tokens before EOT, "avg_logprob": the
    program's, "first": whether the window opens its file (its language
    was detected from it)}.
    control: judge instead, at every position of the same prompts and
    tokens, "fp8": the token that the reference with every product's
    operands in float8 e4m3 (per-row scales) puts first, and that
    reference's mean log-probability of the served tokens; or
    "second_best": the reference's second-best token under the grammar,
    reported with its own log-probability (a wrong argmax)."""
    t0 = time.perf_counter()
    model = ref.Whisper(cfg, weights.whisper_state(cfg, seed, device), device)
    sp = ref.Specials(cfg["vocab_size"])
    lang = slice(sp.languages.start, sp.languages.stop)
    found, where = [], []                   # gaps; (largest gap, where) of each sample
    lp_gaps = []                            # |mean log-prob: judged − reference| of each sample
    with torch.no_grad():
        for lo in range(0, len(samples), 4):
            group = samples[lo:lo + 4]
            pcm = torch.from_numpy(np.stack([ref.to_pcm(s["audio"]) for s in group])).to(device)
            mel = ref.log_mel(pcm, cfg["num_mel_bins"])
            cross = model.cross_kv(model.encode(mel))
            lower = None
            if control == "fp8":
                model.fp8 = True
                lower = model.cross_kv(model.encode(mel))
                model.fp8 = False
            for j, s in enumerate(group):
                p, n = s["prompt"], s["n"]
                served = s["tokens"][p:p + min(n + 1, len(s["tokens"]) - p)]
                seq = torch.tensor(s["tokens"][:p + len(served) - 1], device=device)[None]
                logits = model.decode(seq, [(k[j:j + 1], v[j:j + 1]) for k, v in cross])[0]
                allowed = ref.allowed_masks(sp, served, device)
                judged, lang_tok = served, s["tokens"][1] if p > 1 else None
                reported, avg_judged = served, s.get("avg_logprob")
                if control == "fp8":
                    model.fp8 = True
                    ctl = model.decode(seq, [(k[j:j + 1], v[j:j + 1]) for k, v in lower])[0]
                    model.fp8 = False
                    judged = ref.preferred(ctl[p - 1:], allowed, sp.timestamp_begin)
                    lang_tok = sp.languages.start + int(ctl[0, lang].argmax())
                    avg_judged = ref.mean_logprob(ctl[p - 1:], served, allowed,
                                                  sp.timestamp_begin, n + 1)
                elif control == "second_best":
                    judged = reported = ref.preferred(logits[p - 1:], allowed,
                                                      sp.timestamp_begin, rank=1)
                    avg_judged = ref.mean_logprob(logits[p - 1:], judged, allowed,
                                                  sp.timestamp_begin, n + 1)
                g = ref.token_gaps(logits[p - 1:], judged, allowed, sp.timestamp_begin)
                found.append(g)
                avg_ref = ref.mean_logprob(logits[p - 1:], reported, allowed,
                                           sp.timestamp_begin, n + 1)
                if avg_judged is not None:
                    lp_gaps.append(abs(avg_judged - avg_ref))
                i = int(torch.nan_to_num(g, nan=float("inf")).argmax())
                where.append((float(g[i]), {"sample": lo + j, "position": i,
                                            "judged": int(judged[i]),
                                            "best": int(logits[p - 1 + i].masked_fill(
                                                ~allowed[i], ref.NEG).argmax())}))
                if s["first"] and lang_tok is not None:
                    found.append((logits[0, lang].max() - logits[0, lang_tok]).view(1))
                    where.append((float(found[-1][0]), {"sample": lo + j, "language": lang_tok}))
    stats = gaps.summary(found)
    worst = max(where, key=lambda w: w[0])[1] if where else {}
    seconds = time.perf_counter() - t0
    return [{"name": "logprob_gap", "value": max(lp_gaps) if lp_gaps else float("inf"),
             "limit": limits["logprob_gap"], "windows": [round(x, 6) for x in lp_gaps]},
            {"name": "token_gap", "value": stats["max"], "limit": limits["token_gap"], **stats,
             "worst": worst, "seconds": seconds}]


class Entry:
    """The ASR entries' shared part. A subclass builds `self.pool` and
    defines `run(k)` (one call of the pool, returning the port's results)
    and `files(k)`: the float audio of each of call k's files as the port
    reads it."""

    def __init__(self, ctx):
        self.ctx = ctx
        self.tr = transcriber(ctx.config, ctx.traffic, ctx.seed, ctx.device)
        self.tap = DecodeTap(ctx.tracing)
        self.inst = None
        self.served: dict[int, list] = {}        # call index → its T = 0 decodes
        self.decodes: dict[int, list] = {}       # call index → (steps, prompt, rows) of each decode
        self._spans = 0

    def windows(self, k: int) -> int:
        return sum(traffic.n_windows(len(a)) for a in self.files(k))

    def instrument(self) -> None:
        """After the warm-up: spans and costs of the window's calls only."""
        self.inst = Instruments(self.tr)
        self.tap.spans.clear()
        self._spans = 0

    def audio_s(self, k: int) -> float:
        return sum(len(a) for a in self.files(k)) / traffic.SAMPLE_RATE

    def record(self, index: int, k: int) -> dict:
        """After call `index` ran pool call k: keep its temperature-0
        decodes (and, traced, its decodes' steps); its work."""
        self.served[index] = [(r.tokens, r.lengths, r.avg_logprobs) for r in self.tap.take()]
        self.decodes[index] = [(s[1], s[3], s[2]) for s in self.tap.spans[self._spans:]]
        self._spans = len(self.tap.spans)
        return {"audio_s": self.audio_s(k), "windows": self.windows(k)}

    def call_flops(self, index: int, k: int) -> float:
        return call_flops(self.ctx.config, self.windows(k), self.decodes[index])

    def chosen_calls(self, calls, rng) -> list:
        return sorted(rng.choice(len(calls), size=min(self.ctx.cell["check_calls"], len(calls)),
                                 replace=False))

    def samples(self, calls) -> list[dict]:
        """The windows the check compares: calls drawn from the seed among
        those finished (`chosen_calls`), `check_rows` windows of each."""
        rng = np.random.default_rng(self.ctx.seed)
        out = []
        for ci in self.chosen_calls(calls, rng):
            c = calls[ci]
            files = self.files(c.pool)
            plan = [(fi, s, s == 0) for fi, a in enumerate(files)
                    for s in traffic.window_starts(len(a))]
            results = self.served[c.index]
            bsz = results[0][0].shape[0]
            rows = min(self.ctx.cell["check_rows"], len(plan))
            for w in sorted(rng.choice(len(plan), size=rows, replace=False)):
                fi, start, first = plan[w]
                tokens, lengths, avg = (t.cpu() for t in results[w // bsz])
                out.append({"audio": ref.window(files[fi], start),
                            "tokens": tokens[w % bsz].tolist(),
                            "prompt": tokens.shape[1] - self.tr.config.max_decode_len,
                            "n": int(lengths[w % bsz]), "avg_logprob": float(avg[w % bsz]),
                            "first": first})
        return out

    def check(self, calls) -> list[dict]:
        samples = self.samples(calls)
        self.release()
        return check(self.ctx.config, self.ctx.seed, self.ctx.device, samples,
                     self.ctx.cell["limits"])

    def release(self) -> None:
        """Frees the port's state: the transcriber, its model, the taps."""
        if self.inst is not None:
            self.inst.close()
        self.tap.close()
        self.tr = self.inst = None
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def close(self) -> None:
        pass
