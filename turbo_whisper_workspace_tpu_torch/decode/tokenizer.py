"""Port copy of turbo_whisper_workspace_tpu/decode/tokenizer.py, unchanged.

Whisper tokenizer: byte-level BPE + the special-token grammar.

The reference gets tokenization implicitly through the HF pipeline
(vocalis/core/audio_pipeline.py:195-200). Here the grammar — SOT
sequence, language tokens, task tokens, timestamp tokens — is derived
arithmetically from the vocabulary size (the layout is fixed per Whisper
family), so decode-side constraint masks (decode/rules.py) need no
vocabulary files at all. Text en/decoding uses a GPT-2-style byte-level
BPE when vocab.json + merges.txt are available locally; otherwise a
byte-fallback tokenizer keeps every pipeline stage functional offline
(degrade-and-continue, the reference's own style — e.g.
vocalis/core/audio_utils.py:76).
"""

from __future__ import annotations

import functools
import json
import os
from dataclasses import dataclass, field

# openai/whisper language registry in token-id order; the first 99 are the
# v1/v2 languages, "yue" (#100) exists only in large-v3 vocabularies.
LANGUAGES = (
    "en zh de es ru ko fr ja pt tr pl ca nl ar sv it id hi fi vi he uk el ms "
    "cs ro da hu ta no th ur hr bg lt la mi ml cy sk te fa lv bn sr az sl kn "
    "et mk br eu is hy ne mn bs kk sq sw gl mr pa si km sn yo so af oc ka be "
    "tg sd gu am yi lo uz fo ht ps tk nn mt sa lb my bo tl mg as tt haw ln "
    "ha ba jw su yue"
).split()


@dataclass(frozen=True)
class SpecialTokens:
    """Special-token ids for a given Whisper vocabulary size."""

    n_vocab: int
    eot: int
    sot: int
    n_languages: int
    translate: int
    transcribe: int
    sot_lm: int
    sot_prev: int
    no_speech: int
    no_timestamps: int
    timestamp_begin: int
    multilingual: bool

    @property
    def language_tokens(self) -> dict[str, int]:
        return {
            lang: self.sot + 1 + i for i, lang in enumerate(LANGUAGES[: self.n_languages])
        }

    def timestamp_token(self, seconds: float) -> int:
        return self.timestamp_begin + int(round(seconds / 0.02))

    def timestamp_seconds(self, token: int) -> float:
        return (token - self.timestamp_begin) * 0.02

    def is_timestamp(self, token: int) -> bool:
        return token >= self.timestamp_begin

    def sot_sequence(
        self, language: str | None = "en", task: str = "transcribe",
        timestamps: bool = True,
    ) -> list[int]:
        """<|sot|> [<|lang|> <|task|>] [<|notimestamps|>]."""
        seq = [self.sot]
        if self.multilingual:
            lang_id = self.language_tokens.get(language or "en")
            seq.append(lang_id)
            seq.append(self.translate if task == "translate" else self.transcribe)
        if not timestamps:
            seq.append(self.no_timestamps)
        return seq


def special_tokens_for_vocab(n_vocab: int) -> SpecialTokens:
    """Derive the fixed special-token layout from vocabulary size.

    51864 = English-only, 51865 = multilingual v1/v2, 51866 = v3 family.
    Smaller (test) vocabularies get a proportionally scaled layout with
    the same ordering so decode rules stay exercised.
    """
    if n_vocab >= 51865:  # multilingual
        n_lang = n_vocab - 51766  # 99 for 51865 (v1/v2), 100 for 51866 (v3)
        eot = 50257
        multilingual = True
    elif n_vocab == 51864:  # English-only
        n_lang = 99
        eot = 50256
        multilingual = False
    else:  # scaled test vocab: 10 "languages", same ordering
        n_lang = min(10, max(1, n_vocab // 16))
        eot = max(0, n_vocab - n_lang - 8 - 100)
        multilingual = True
    sot = eot + 1
    translate = sot + 1 + n_lang
    transcribe = translate + 1
    sot_lm = transcribe + 1
    sot_prev = sot_lm + 1
    no_speech = sot_prev + 1
    no_timestamps = no_speech + 1
    timestamp_begin = no_timestamps + 1
    return SpecialTokens(
        n_vocab=n_vocab,
        eot=eot,
        sot=sot,
        n_languages=n_lang,
        translate=translate,
        transcribe=transcribe,
        sot_lm=sot_lm,
        sot_prev=sot_prev,
        no_speech=no_speech,
        no_timestamps=no_timestamps,
        timestamp_begin=timestamp_begin,
        multilingual=multilingual,
    )


@functools.lru_cache()
def _split_pattern():
    """GPT-2 pre-tokenization regex, compiled once (not per encode call)."""
    import regex

    return regex.compile(
        r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""
    )


@functools.lru_cache()
def _byte_encoder() -> dict[int, str]:
    """GPT-2 byte→unicode table (reversible, whitespace-safe)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


class BPETokenizer:
    """GPT-2-style byte-level BPE loaded from local vocab.json+merges.txt."""

    def __init__(self, vocab: dict[str, int], merges: list[tuple[str, str]]):
        self.encoder = vocab
        self.decoder = {v: k for k, v in vocab.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.byte_encoder = _byte_encoder()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self._cache: dict[str, list[str]] = {}

    @classmethod
    def from_dir(cls, path: str) -> "BPETokenizer":
        with open(os.path.join(path, "vocab.json")) as f:
            vocab = json.load(f)
        merges = []
        with open(os.path.join(path, "merges.txt")) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#version"):
                    continue
                a, b = line.split()
                merges.append((a, b))
        return cls(vocab, merges)

    @classmethod
    def from_tokenizer_json(cls, path: str) -> "BPETokenizer":
        """Load the HF fast-tokenizer format (the file HF actually ships
        for openai/whisper-* checkpoints; vocab.json+merges.txt often
        aren't present). Handles both merge encodings tokenizers has
        used: "a b" strings and ["a", "b"] pairs."""
        with open(path, encoding="utf-8") as f:
            blob = json.load(f)
        model = blob["model"]
        vocab = dict(model["vocab"])
        # added_tokens carry the specials (<|endoftext|>, timestamps, …)
        for tok in blob.get("added_tokens", ()):
            vocab.setdefault(tok["content"], tok["id"])
        merges = []
        for m in model.get("merges", ()):
            if isinstance(m, str):
                a, b = m.split(" ", 1)
            else:
                a, b = m
            merges.append((a, b))
        return cls(vocab, merges)

    def _bpe(self, token: str) -> list[str]:
        if token in self._cache:
            return self._cache[token]
        word = list(token)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            a, b = best
            merged, i = [], 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == a and word[i + 1] == b:
                    merged.append(a + b)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged
        self._cache[token] = word
        return word

    def encode(self, text: str) -> list[int]:
        ids: list[int] = []
        for piece in _split_pattern().findall(text):
            piece = "".join(self.byte_encoder[b] for b in piece.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(piece))
        return ids

    def decode(self, ids) -> str:
        text = "".join(self.decoder.get(int(i), "") for i in ids)
        raw = bytearray(self.byte_decoder.get(c, ord(" ")) for c in text)
        return raw.decode("utf-8", errors="replace")


class TiktokenTokenizer:
    """openai/whisper's shipped vocabulary format (gpt2.tiktoken /
    multilingual.tiktoken): one `base64(token_bytes) rank` pair per line.
    Tokens are raw byte strings — no GPT-2 byte→unicode indirection."""

    def __init__(self, ranks: dict[bytes, int]):
        self.ranks = ranks
        self.decoder = {v: k for k, v in ranks.items()}
        self._cache: dict[bytes, list[int]] = {}

    @classmethod
    def from_file(cls, path: str) -> "TiktokenTokenizer":
        import base64

        ranks: dict[bytes, int] = {}
        with open(path, "rb") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                tok, rank = line.split()
                ranks[base64.b64decode(tok)] = int(rank)
        return cls(ranks)

    def _bpe(self, piece: bytes) -> list[int]:
        if piece in self._cache:
            return self._cache[piece]
        if piece in self.ranks:
            out = [self.ranks[piece]]
            self._cache[piece] = out
            return out
        parts = [piece[i : i + 1] for i in range(len(piece))]
        while len(parts) > 1:
            best_rank, best_i = None, None
            for i in range(len(parts) - 1):
                r = self.ranks.get(parts[i] + parts[i + 1])
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_i = r, i
            if best_i is None:
                break
            parts[best_i : best_i + 2] = [parts[best_i] + parts[best_i + 1]]
        out = [self.ranks[p] for p in parts if p in self.ranks]
        self._cache[piece] = out
        return out

    def encode(self, text: str) -> list[int]:
        ids: list[int] = []
        for piece in _split_pattern().findall(text):
            ids.extend(self._bpe(piece.encode("utf-8")))
        return ids

    def decode(self, ids) -> str:
        raw = b"".join(self.decoder.get(int(i), b"") for i in ids)
        return raw.decode("utf-8", errors="replace")


class ByteFallbackTokenizer:
    """Offline fallback: ids 0-255 are raw bytes. Keeps every text-consuming
    stage (merge, LLM prompts, security regex) functional without vocab
    files; replaced transparently when a local BPE vocabulary exists."""

    def encode(self, text: str) -> list[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids) -> str:
        return bytes(int(i) for i in ids if 0 <= int(i) < 256).decode(
            "utf-8", errors="replace"
        )


@dataclass
class WhisperTokenizer:
    """Special-token grammar + text codec for one Whisper vocabulary."""

    specials: SpecialTokens
    codec: object = field(default_factory=ByteFallbackTokenizer)

    @classmethod
    def for_model(cls, n_vocab: int, vocab_dir: str | None = None):
        """Resolution ladder over every vocabulary format Whisper ships in:
        HF slow (vocab.json+merges.txt), HF fast (tokenizer.json), openai
        tiktoken (*.tiktoken); byte-fallback keeps the stack functional
        when none exist (degrade-and-continue)."""
        specials = special_tokens_for_vocab(n_vocab)
        codec: object = ByteFallbackTokenizer()
        if vocab_dir and os.path.isdir(vocab_dir):
            loaders = []
            if os.path.exists(os.path.join(vocab_dir, "vocab.json")):
                loaders.append(lambda: BPETokenizer.from_dir(vocab_dir))
            tok_json = os.path.join(vocab_dir, "tokenizer.json")
            if os.path.exists(tok_json):
                loaders.append(lambda: BPETokenizer.from_tokenizer_json(tok_json))
            for name in sorted(os.listdir(vocab_dir)):
                if name.endswith(".tiktoken"):
                    path = os.path.join(vocab_dir, name)
                    loaders.append(
                        lambda p=path: TiktokenTokenizer.from_file(p)
                    )
            for load in loaders:
                try:
                    codec = load()
                    break
                except Exception:
                    continue
        return cls(specials=specials, codec=codec)

    def encode(self, text: str) -> list[int]:
        return self.codec.encode(text)

    def decode_text(self, ids) -> str:
        """Decode, skipping all special/timestamp tokens."""
        sp = self.specials
        return self.codec.decode([i for i in ids if int(i) < sp.eot])

    def split_timestamps(self, ids) -> list[dict]:
        """Token stream → [{"start","end","tokens"}] using timestamp pairs."""
        sp = self.specials
        out, cur, start = [], [], None
        for i in ids:
            i = int(i)
            if i >= sp.timestamp_begin:
                t = sp.timestamp_seconds(i)
                if start is None:
                    start = t
                else:
                    out.append({"start": start, "end": t, "tokens": cur})
                    cur, start = [], None
            elif i < sp.eot:
                if start is None:
                    start = 0.0
                cur.append(i)
        if cur:
            out.append({"start": start or 0.0, "end": None, "tokens": cur})
        return out
