"""Plain float32 Whisper: the reference the ASR cells' output is held to.

Written from openai/whisper's published description, in plain torch
operations, with TF32 off: the log-mel frontend (an STFT with a periodic
Hann window, Slaney mel filters, log10 floored at the clip's max − 8),
the encoder (two GELU convolutions, sinusoidal positions, pre-LN blocks),
the cross-attention K and V with the int8 quantization the configuration
states (symmetric, one scale per layer, window and head), and the decoder
run teacher-forced over a prompt and the tokens served for it, with the
timestamp rules of openai/whisper's decoding. It imports nothing of the
port; the weights it reads are the benchmark's own draw (`lib/weights.py`).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE = 16_000
N_FFT = 400
HOP = 160
N_SAMPLES = 30 * SAMPLE_RATE
NEG = float("-inf")

# openai/whisper's non-speech suppress list of the multilingual vocabularies
SUPPRESS = (
    1, 2, 7, 8, 9, 10, 14, 25, 26, 27, 28, 29, 31, 58, 59, 60, 61, 62, 63,
    90, 91, 92, 93, 359, 503, 522, 542, 873, 893, 902, 918, 922, 931, 1350,
    1853, 1982, 2460, 2627, 3246, 3253, 3268, 3536, 3846, 3961, 4183, 4667,
    6585, 6647, 7273, 9061, 9383, 10428, 10929, 11938, 12033, 12331, 12562,
    13793, 14157, 14635, 15265, 15618, 16553, 16604, 18362, 18956, 20075,
    21675, 22520, 26130, 26161, 26435, 28279, 29464, 31650, 32302, 32470,
    36865, 42863, 47425, 49870, 50254,
)


def full_f32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3, one scale per row (amax → 448), back in f32."""
    s = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12) / 448.0
    return (x / s).to(torch.float8_e4m3fn).float() * s


# ---------------------------------------------------------------------------
# frontend


def mel_filters(n_mels: int, sr: int = SAMPLE_RATE, n_fft: int = N_FFT) -> np.ndarray:
    """Slaney-scale, Slaney-normalised triangular filters (n_mels, n_fft/2+1)."""
    def hz_to_mel(f):
        f = np.asarray(f, np.float64)
        lin = f / (200.0 / 3)
        log = 15.0 + np.log(np.maximum(f, 1000.0) / 1000.0) / (np.log(6.4) / 27.0)
        return np.where(f >= 1000.0, log, lin)

    def mel_to_hz(m):
        m = np.asarray(m, np.float64)
        lin = m * (200.0 / 3)
        log = 1000.0 * np.exp((np.log(6.4) / 27.0) * (m - 15.0))
        return np.where(m >= 15.0, log, lin)

    freqs = np.linspace(0, sr / 2, n_fft // 2 + 1)
    pts = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(sr / 2), n_mels + 2))
    lower = (freqs[None, :] - pts[:-2, None]) / (pts[1:-1] - pts[:-2])[:, None]
    upper = (pts[2:, None] - freqs[None, :]) / (pts[2:] - pts[1:-1])[:, None]
    w = np.maximum(0.0, np.minimum(lower, upper))
    return w * (2.0 / (pts[2:] - pts[:-2]))[:, None]


def log_mel(pcm: torch.Tensor, n_mels: int) -> torch.Tensor:
    """int16 PCM windows (B, 480000) → log-mel (B, n_mels, 3000) f32."""
    x = pcm.float() / 32768.0
    spec = torch.stft(x, N_FFT, HOP, window=torch.hann_window(N_FFT, device=x.device),
                      center=True, pad_mode="reflect", return_complex=True)
    power = spec[..., :-1].abs() ** 2
    filters = torch.from_numpy(mel_filters(n_mels)).float().to(x.device)
    mel = torch.einsum("mf,bft->bmt", filters, power)
    log = torch.log10(mel.clamp_min(1e-10))
    log = torch.maximum(log, log.amax(dim=(1, 2), keepdim=True) - 8.0)
    return (log + 4.0) / 4.0


def to_pcm(audio: np.ndarray) -> np.ndarray:
    """Float samples → int16 PCM, clipped."""
    return np.clip(audio * 32768.0, -32768, 32767).astype(np.int16)


def window(audio: np.ndarray, start: int) -> np.ndarray:
    seg = audio[start:start + N_SAMPLES]
    return np.pad(seg, (0, N_SAMPLES - len(seg))).astype(np.float32)


# ---------------------------------------------------------------------------
# model


def sinusoids(length: int, channels: int) -> torch.Tensor:
    inc = math.log(10000.0) / (channels // 2 - 1)
    inv = torch.exp(-inc * torch.arange(channels // 2, dtype=torch.float64))
    ang = torch.arange(length, dtype=torch.float64)[:, None] * inv[None, :]
    return torch.cat([ang.sin(), ang.cos()], 1).float()


class Whisper:
    """cfg: the configuration file's dict; state: {name: tensor} under the
    names of `lib/weights.whisper_state` (nn.Linear weights (out, in))."""

    def __init__(self, cfg: dict, state: dict, device):
        self.cfg = cfg
        self.w = {k: v.to(device, torch.float32) for k, v in state.items()
                  if k != "encoder.pos_emb"}
        self.d = cfg["d_model"]
        self.heads_enc = cfg["encoder_attention_heads"]
        self.heads_dec = cfg["decoder_attention_heads"]
        self.bits = cfg.get("cross_kv_quantization", {}).get("bits", 8)
        self.fp8 = False           # the control: every product's operands in fp8
        self.pos_enc = sinusoids(cfg["max_source_positions"], self.d).to(device)
        full_f32()

    def lin(self, x, name, bias=True):
        w = self.w[f"{name}.weight"]
        if self.fp8:
            x, w = fp8(x), fp8(w)
        y = x @ w.t()
        b = self.w.get(f"{name}.bias") if bias else None
        return y + b if b is not None else y

    def ln(self, x, name):
        return F.layer_norm(x, (self.d,), self.w[f"{name}.weight"], self.w[f"{name}.bias"], 1e-5)

    @staticmethod
    def attend(q, k, v, heads, causal=False):
        b, tq, d = q.shape
        dh = d // heads
        q = q.view(b, tq, heads, dh).transpose(1, 2)
        k = k.reshape(b, -1, heads, dh).transpose(1, 2) if k.dim() == 3 else k
        v = v.reshape(b, -1, heads, dh).transpose(1, 2) if v.dim() == 3 else v
        s = (q @ k.transpose(-1, -2)) / math.sqrt(dh)
        if causal:
            t = s.shape[-1]
            s = s.masked_fill(torch.ones(tq, t, dtype=torch.bool, device=s.device).triu(1), NEG)
        return (s.softmax(-1) @ v).transpose(1, 2).reshape(b, tq, d)

    def encode(self, mel: torch.Tensor) -> torch.Tensor:
        """(B, n_mels, 3000) → (B, 1500, d)."""
        x = F.gelu(F.conv1d(mel, self.w["encoder.conv1.weight"], self.w["encoder.conv1.bias"],
                            padding=1))
        x = F.gelu(F.conv1d(x, self.w["encoder.conv2.weight"], self.w["encoder.conv2.bias"],
                            stride=2, padding=1))
        x = x.transpose(1, 2) + self.pos_enc
        for i in range(self.cfg["encoder_layers"]):
            p = f"encoder.blocks.{i}"
            h = self.ln(x, f"{p}.attn_ln")
            a = self.attend(self.lin(h, f"{p}.attn.q"), self.lin(h, f"{p}.attn.k", False),
                            self.lin(h, f"{p}.attn.v"), self.heads_enc)
            x = x + self.lin(a, f"{p}.attn.out")
            h = self.ln(x, f"{p}.mlp_ln")
            x = x + self.lin(F.gelu(self.lin(h, f"{p}.mlp.fc1")), f"{p}.mlp.fc2")
        return self.ln(x, "encoder.ln_post")

    @staticmethod
    def quantize(x: torch.Tensor, bits: int) -> torch.Tensor:
        """(B, H, T, Dh) → dequantized: one symmetric scale per (B, H)."""
        qmax = 2 ** (bits - 1) - 1
        s = (x.abs().amax(dim=(-2, -1), keepdim=True) / qmax).clamp_min(1e-12)
        return torch.clamp(torch.round(x / s), -qmax, qmax) * s

    def cross_kv(self, feats: torch.Tensor) -> list:
        """Each decoder layer's cross-attention (K, V), (B, H, T, Dh),
        quantized at the configured width."""
        b, t, d = feats.shape
        h, bits = self.heads_dec, self.bits
        out = []
        for i in range(self.cfg["decoder_layers"]):
            p = f"decoder.blocks.{i}.cross"
            k = self.lin(feats, f"{p}.k", False).view(b, t, h, d // h).transpose(1, 2)
            v = self.lin(feats, f"{p}.v").view(b, t, h, d // h).transpose(1, 2)
            out.append((self.quantize(k, bits), self.quantize(v, bits)))
        return out

    def decode(self, tokens: torch.Tensor, cross: list) -> torch.Tensor:
        """Teacher-forced logits (B, T, vocab) of tokens (B, T) from position 0."""
        t = tokens.shape[1]
        x = self.w["decoder.token_emb"][tokens] + self.w["decoder.pos_emb"][:t]
        for i in range(self.cfg["decoder_layers"]):
            p = f"decoder.blocks.{i}"
            h = self.ln(x, f"{p}.attn_ln")
            a = self.attend(self.lin(h, f"{p}.attn.q"), self.lin(h, f"{p}.attn.k", False),
                            self.lin(h, f"{p}.attn.v"), self.heads_dec, causal=True)
            x = x + self.lin(a, f"{p}.attn.out")
            h = self.ln(x, f"{p}.cross_ln")
            k, v = cross[i]
            x = x + self.lin(self.attend(self.lin(h, f"{p}.cross.q"), k, v, self.heads_dec),
                             f"{p}.cross.out")
            h = self.ln(x, f"{p}.mlp_ln")
            x = x + self.lin(F.gelu(self.lin(h, f"{p}.mlp.fc1")), f"{p}.mlp.fc2")
        x, emb = self.ln(x, "decoder.ln"), self.w["decoder.token_emb"]
        if self.fp8:
            x, emb = fp8(x), fp8(emb)
        return x @ emb.t()


# ---------------------------------------------------------------------------
# the decoding grammar


class Specials:
    """openai/whisper's special-token layout for a vocabulary size (the
    multilingual 51865 / 51866 ones; a smaller test vocabulary keeps the
    order with ten languages)."""

    def __init__(self, n_vocab: int):
        if n_vocab >= 51865:
            self.n_languages, self.eot = n_vocab - 51766, 50257
        else:
            self.n_languages = min(10, max(1, n_vocab // 16))
            self.eot = max(0, n_vocab - self.n_languages - 8 - 100)
        self.n_vocab = n_vocab
        self.sot = self.eot + 1
        self.translate = self.sot + 1 + self.n_languages
        self.transcribe = self.translate + 1
        self.sot_lm, self.sot_prev = self.transcribe + 1, self.transcribe + 2
        self.no_speech, self.no_timestamps = self.transcribe + 3, self.transcribe + 4
        self.timestamp_begin = self.transcribe + 5
        self.languages = range(self.sot + 1, self.sot + 1 + self.n_languages)


def allowed_masks(sp: Specials, served: list[int], device) -> torch.Tensor:
    """(n, V) bool: the tokens the grammar allows at each of the n sampled
    positions of one row, given the tokens `served` there before it:
    suppressed specials and non-speech tokens, the first token a
    timestamp of at most 1 s (no blank, no EOT), timestamps in pairs, no
    timestamp below the last one (a segment's end past its start). The
    rule that forces a timestamp when their total probability beats every
    other token is applied by `token_gaps`."""
    v = sp.n_vocab
    tb = sp.timestamp_begin
    static = torch.ones(v, dtype=torch.bool)
    banned = [sp.sot, sp.sot_prev, sp.sot_lm, sp.no_speech, sp.translate, sp.transcribe,
              sp.no_timestamps, *sp.languages]
    if v >= 51864:
        banned += [i for i in SUPPRESS if i < v]
    static[banned] = False
    ids = torch.arange(v)
    rows = []
    floor = tb
    for i in range(len(served)):
        ok = static.clone()
        if i == 0:
            if v > 220:
                ok[220] = False
            ok[sp.eot] = False
            ok[:tb] = False
            ok[tb + int(1.0 / 0.02) + 1:] = False
        else:
            last_ts = served[i - 1] >= tb
            penult_ts = i < 2 or served[i - 2] >= tb
            if last_ts and penult_ts:
                ok[tb:] = False
            elif last_ts:
                ok[:sp.eot] = False
            ok[(ids >= tb) & (ids < floor)] = False
        rows.append(ok)
        tok, prev = served[i], served[i - 1] if i else 0
        if tok >= tb:
            floor = max(floor, tok + 1) if prev >= tb else max(floor, tok)
        elif prev >= tb:
            floor = max(floor, prev + 1)
    return torch.stack(rows).to(device)


def token_gaps(logits: torch.Tensor, served: list[int], allowed: torch.Tensor,
               timestamp_begin: int) -> torch.Tensor:
    """(n,) f32: at each sampled position, by how much the reference's
    best allowed token beats the served one (0 where they agree; inf where
    the grammar bans the served token).

    The rule that forces a timestamp when the timestamps' total
    probability beats every other token is decided by the logits, so a
    near-tie may fall either way in the program and the reference. The
    gap is the smaller of the two readings: under the reference's
    decision, and under the other decision plus the margin by which the
    reference took its own."""
    lg = logits.masked_fill(~allowed, NEG)
    is_ts = torch.zeros(lg.shape[-1], dtype=torch.bool, device=lg.device)
    is_ts[timestamp_begin:] = True
    ts_lse = torch.logsumexp(lg.masked_fill(~is_ts, NEG), -1)
    max_text = lg.masked_fill(is_ts, NEG).amax(-1)
    max_ts = lg.masked_fill(~is_ts, NEG).amax(-1)
    force = ts_lse > max_text
    margin = (ts_lse - max_text).abs()
    tok = torch.tensor(served, device=lg.device)
    own = lg.gather(-1, tok[:, None])[:, 0]
    free = lg.amax(-1) - own                                  # the rule not applied
    forced = torch.where(tok >= timestamp_begin, max_ts - own, torch.inf)
    gap = torch.where(force, torch.minimum(forced, margin + free),
                      torch.minimum(free, margin + forced))
    return torch.where(torch.isneginf(own), torch.inf, gap)


def mean_logprob(logits: torch.Tensor, served: list[int], allowed: torch.Tensor,
                 timestamp_begin: int, count: int) -> float:
    """Σ log-probability of the served tokens / count: at each position
    the softmax over the allowed tokens, or over the allowed timestamps
    where the served token is one. A timestamp is served only where the
    rule that forces timestamps held (a timestamp that beats every other
    token also carries the timestamps' mass past it), so the served token's
    kind tells the decision the program took; -inf for a banned token."""
    lg = logits.masked_fill(~allowed, NEG)
    tok = torch.tensor(served, device=lg.device)
    is_ts = torch.zeros(lg.shape[-1], dtype=torch.bool, device=lg.device)
    is_ts[timestamp_begin:] = True
    forced = (tok >= timestamp_begin)[:, None] & ~is_ts[None]
    logp = torch.log_softmax(lg.masked_fill(forced, NEG), -1)
    return float(logp.gather(-1, tok[:, None]).sum()) / count


def preferred(logits: torch.Tensor, allowed: torch.Tensor, timestamp_begin: int,
              rank: int = 0) -> list[int]:
    """The token these logits put first (rank 0; second at rank 1, ...)
    at each position under the grammar and the timestamp rule (the
    control's choice)."""
    lg = logits.masked_fill(~allowed, NEG)
    is_ts = torch.zeros(lg.shape[-1], dtype=torch.bool, device=lg.device)
    is_ts[timestamp_begin:] = True
    force = torch.logsumexp(lg.masked_fill(~is_ts, NEG), -1) > lg.masked_fill(is_ts, NEG).amax(-1)
    lg = torch.where(force[:, None] & ~is_ts, torch.full_like(lg, NEG), lg)
    return (lg.argmax(-1) if rank == 0 else lg.topk(rank + 1, -1).indices[:, rank]).tolist()
