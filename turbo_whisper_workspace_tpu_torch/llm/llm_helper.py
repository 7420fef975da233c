"""LLM enrichment helpers: speaker naming, summarization, topics.

Port of turbo_whisper_workspace_tpu/llm/llm_helper.py. `TorchLlama`
takes the place of `TPULlama`; `get_llm` takes the device the model is
loaded on (CUDA unless the caller asks for the CPU; it raises without a
GPU only when there is a checkpoint to load). Everything else is the JAX
module's, line for line.

API surface mirrors the reference's llm_helper
(vocalis/llm/llm_helper.py / legacy llm_helper.py): `get_llm`,
`generate_text`, `identify_speaker_names_llm`,
`identify_speaker_names_fallback`, `summarize_conversation`,
`extract_topics`, plus the legacy extras worth keeping — a `DummyLLM`
stub (llm_helper.py:361-371), an idle auto-unload timer
(llm_helper.py:46-96, 120 s), and JSON-repair parsing ladders
(llm_helper.py:528-561).

The engine is the Llama decoder (models/llama.py + llm/generate.py)
loaded from a local checkpoint, or, where the checkpoint's config.json
names model_type "deepseek_v3" (Moonlight-16B-A3B), the DeepSeek-V3
decoder (models/deepseek_v3.py), which the JAX package does not have;
with no checkpoint on disk every task
degrades to its deterministic rule-based fallback — the reference's own
LLM→rules→dummy ladder (vocalis/core/audio_pipeline.py:506-521).
"""

from __future__ import annotations

import json
import logging
import os
import re
import threading
import time
from collections import Counter

import torch

from ..config import LLMConfig
from ..utils import profiling
from ..utils.common_data import COMMON_NAMES

logger = logging.getLogger(__name__)

IDLE_UNLOAD_S = 120.0      # legacy llm_helper.py:46-96

_llm_instance = None
_llm_lock = threading.Lock()
_last_use = 0.0
_unload_timer: threading.Timer | None = None


class DummyLLM:
    """Inert stand-in so callers never branch on None
    (legacy llm_helper.py:361-371)."""

    is_dummy = True

    def generate(self, prompt: str, max_tokens: int = 256,
                 temperature: float = 0.1, stop=()) -> str:
        return ""


class TorchLlama:
    """A decoder-only LM (Llama, or DeepSeek-V3 when `dims` are
    `DeepseekV3Dims`) on a torch device, with a byte-fallback tokenizer
    when no vocabulary files accompany the checkpoint; token 0 is EOS.
    Counterpart of the JAX package's TPULlama. `last_generation` holds
    the prompt and generated token counts and the prefill and decode
    wall seconds of the last call. The span `llm.generate` covers the
    generation and the tokens' copy back; the tokenizer's work is its
    caller's. It takes `params` as its own and joins their int4 sibling
    projections in place (the family's `fuse_siblings`: q, k and v, and
    gate and up, or q and kv_a, and the gate and up of the dense layer
    and of the experts), then run as one matmul each. The caller's dict
    is that same dict, and no longer holds the separate tensors."""

    is_dummy = False

    def __init__(self, params, dims, tokenizer=None,
                 device: torch.device | str = "cuda"):
        from ..decode.tokenizer import ByteFallbackTokenizer
        from ..pipeline.transcriber import resolve_device
        from .generate import family

        self.dims = dims
        self.tokenizer = tokenizer or ByteFallbackTokenizer()
        self.device = resolve_device(device)
        self.params = family(dims).fuse_siblings(params)
        self.last_generation: dict = {}

    def generate(self, prompt: str, max_tokens: int = 256,
                 temperature: float = 0.1, stop=()) -> str:
        from .generate import generate_tokens

        ids = self.tokenizer.encode(prompt)[-(self.dims.max_ctx - max_tokens):]
        timings: dict = {}
        with profiling.span("llm.generate"):
            res = generate_tokens(
                self.params, self.dims,
                torch.tensor([ids], dtype=torch.long, device=self.device),
                max_len=max_tokens, temperature=float(temperature), timings=timings,
            )
            n = int(res.lengths[0])
            out = res.tokens[0, len(ids):][:n].tolist()
        self.last_generation = {"prompt_tokens": len(ids), "new_tokens": n, **timings}
        text = self.tokenizer.decode(out)
        for s in stop:
            if s in text:
                text = text.split(s)[0]
        return text


def _schedule_unload():
    global _unload_timer

    def unload():
        global _llm_instance
        with _llm_lock:
            if _llm_instance is not None and time.time() - _last_use >= IDLE_UNLOAD_S:
                logger.info("unloading idle LLM")
                _llm_instance = None

    if _unload_timer is not None:
        _unload_timer.cancel()
    _unload_timer = threading.Timer(IDLE_UNLOAD_S + 1, unload)
    _unload_timer.daemon = True
    _unload_timer.start()


def get_llm(config: LLMConfig | None = None, device: torch.device | str = "cuda"):
    """Load (and cache) the LLM on `device`; DummyLLM when no checkpoint
    exists.

    Checkpoint probe ladder mirrors vocalis/llm/llm_helper.py:50-55:
    $LLM_MODEL, then models/<name>/, then default names under models/.
    """
    global _llm_instance, _last_use
    config = config or LLMConfig()
    with _llm_lock:
        _last_use = time.time()
        if _llm_instance is not None:
            _schedule_unload()
            return _llm_instance

        candidates = [
            os.environ.get("LLM_MODEL_PATH", ""),
            os.path.join("models", config.model),
            os.path.join("models", "llm"),
        ]
        candidates = [path for path in candidates if path and os.path.isdir(path)]
        if candidates:
            from ..pipeline.transcriber import resolve_device

            device = resolve_device(device)     # raises without the GPU asked for
        for path in candidates:
            try:
                params, dims = _load_llama_checkpoint(path, device)
                if config.quantize_bits in (4, 8):
                    from ..ops.quant import quantize_tree
                    from .generate import family

                    # Q4 operating point (reference serves Q4_K_M,
                    # vocalis/llm/llm_helper.py:67-73): quarter the
                    # weight bytes of the bandwidth-bound decode
                    params = quantize_tree(params, keys=family(dims).QUANT_KEYS,
                                           bits=config.quantize_bits)
                _llm_instance = TorchLlama(params, dims, device=device)
                logger.info("loaded LLM from %s", path)
                break
            except Exception as e:
                logger.warning("LLM load failed from %s: %s", path, e)
        if _llm_instance is None:
            logger.info("no LLM checkpoint found — using DummyLLM")
            _llm_instance = DummyLLM()
        _schedule_unload()
        return _llm_instance


def _load_llama_checkpoint(path: str, device: torch.device | str = "cpu"):
    """(params, dims) of the transformers checkpoint at `path`, by its
    config.json's model_type: "deepseek_v3" loads models/deepseek_v3.py,
    any other the Llama architecture."""
    from ..models import deepseek_v3
    from ..models import llama as lm

    cfg_path = os.path.join(path, "config.json")
    with open(cfg_path) as f:
        c = json.load(f)
    if c.get("model_type") == "deepseek_v3":
        module, dims = deepseek_v3, deepseek_v3.dims_from_hf_config(c)
    else:
        module, dims = lm, lm.LlamaDims(
            n_vocab=c["vocab_size"], d_model=c["hidden_size"],
            n_layer=c["num_hidden_layers"], n_head=c["num_attention_heads"],
            n_kv_head=c.get("num_key_value_heads", c["num_attention_heads"]),
            d_ff=c["intermediate_size"],
            rope_theta=c.get("rope_theta", 500000.0),
            norm_eps=c.get("rms_norm_eps", 1e-5),
        )
    pt = os.path.join(path, "pytorch_model.bin")
    st = os.path.join(path, "model.safetensors")
    if os.path.exists(st):
        from safetensors.torch import load_file

        sd = load_file(st)
    else:
        sd = torch.load(pt, map_location="cpu", weights_only=True)
    params = module.params_from_hf_state_dict(sd, dims, dtype=torch.bfloat16,
                                              device=device)
    return params, dims


def set_llm(instance) -> None:
    """Inject an LLM (tests use this to fake completions — the pattern the
    reference uses with mock transcripts, bar_security_monitor.py:522-560)."""
    global _llm_instance
    with _llm_lock:
        _llm_instance = instance


def generate_text(prompt: str, max_tokens: int = 256, temperature: float = 0.1,
                  stop=(), llm=None) -> str:
    llm = llm or get_llm()
    try:
        return llm.generate(prompt, max_tokens=max_tokens,
                            temperature=temperature, stop=stop)
    except Exception as e:
        logger.error("LLM generation failed: %s", e)
        return ""


# ---------------------------------------------------------------------------
# JSON repair ladder (legacy llm_helper.py:528-561)

def _extract_json(text: str):
    # brace-balanced scan from the first '{' — survives nested objects,
    # which the old \{[^{}]*\} regex could not
    start = text.find("{")
    if start < 0:
        return None
    depth, end, in_str, esc = 0, -1, False, False
    for i, ch in enumerate(text[start:], start):
        if in_str:
            if esc:
                esc = False
            elif ch == "\\":
                esc = True
            elif ch == '"':
                in_str = False
            continue
        if ch == '"':
            in_str = True
        elif ch == "{":
            depth += 1
        elif ch == "}":
            depth -= 1
            if depth == 0:
                end = i
                break
    if end < 0:
        return None
    raw = text[start : end + 1]
    for attempt in (
        raw,
        raw.replace("'", '"'),
        re.sub(r",\s*}", "}", raw.replace("'", '"')),
        re.sub(r"(\w+):", r'"\1":', re.sub(r",\s*}", "}", raw.replace("'", '"'))),
    ):
        try:
            return json.loads(attempt)
        except Exception:
            continue
    return None


# ---------------------------------------------------------------------------
# Speaker naming

def identify_speaker_names_llm(segments, llm=None, config: LLMConfig | None = None):
    """LLM prompt → {"Speaker N": name} (vocalis/llm/llm_helper.py:160-223).
    Returns {} on any failure so callers fall back to rules."""
    config = config or LLMConfig()
    segs = list(segments)[: config.max_segments]
    if not segs:
        return {}
    convo = "\n".join(
        f"{s.get('speaker', 'Speaker 0')}: {s.get('text', '')}" for s in segs
    )
    speakers = sorted({s.get("speaker", "Speaker 0") for s in segs})
    prompt = (
        "Below is a conversation with anonymous speaker labels. Infer the "
        "real first name of each speaker from self-introductions or how "
        "others address them. Reply with ONLY a JSON object mapping each "
        "label to a name, e.g. {\"Speaker 0\": \"Alice\"}. Use the label "
        "itself as value when a name is unknowable.\n\n"
        f"Speakers: {', '.join(speakers)}\n\nConversation:\n{convo}\n\nJSON:"
    )
    out = generate_text(prompt, max_tokens=config.max_tokens_names,
                        temperature=config.temperature_names,
                        stop=("```",), llm=llm)
    data = _extract_json(out)
    if not isinstance(data, dict):
        return {}
    result = {}
    for k, v in data.items():
        if k in speakers and isinstance(v, str) and v.strip():
            name = v.strip().split()[0]
            if name.lower() in COMMON_NAMES or name in speakers:
                result[k] = name.title() if name.lower() in COMMON_NAMES else name
    return result


_SELF_INTRO = [
    re.compile(p, re.IGNORECASE)
    for p in (
        r"\bmy name is (\w+)",
        r"\bi am (\w+)\b",
        r"\bi'm (\w+)\b",
        r"\bthis is (\w+)\b(?!\s+(?:a|an|the)\b)",
        r"\bcall me (\w+)",
    )
]
_ADDRESSING = [
    re.compile(p, re.IGNORECASE)
    for p in (
        r"^(?:hey|hi|hello|thanks|thank you|okay|ok|yes|no|well|so)[,!]?\s+(\w+)\b",
        r"\b(?:hey|hi|hello|thanks|thank you)[,!]?\s+(\w+)[.!?,]",
        r"\bnice to meet you[,!]?\s+(\w+)\b",
    )
]


def identify_speaker_names_fallback(segments) -> dict:
    """Rule-based naming (vocalis/llm/llm_helper.py:225-294 semantics):
    self-introductions name the current speaker (weight 3); addressing
    names a *different* speaker — credited to whichever other speaker
    talks next, or the addressee label if only two (weight 1). Names must
    pass the COMMON_NAMES gate; highest-vote name wins per speaker."""
    segs = [
        {"speaker": s.get("speaker", "Speaker 0"), "text": s.get("text", "")}
        for s in segments
    ]
    votes: dict[str, Counter] = {}

    def vote(speaker, name, w):
        name = name.lower()
        if name in COMMON_NAMES:
            votes.setdefault(speaker, Counter())[name] += w

    speakers = sorted({s["speaker"] for s in segs})
    for i, seg in enumerate(segs):
        text = seg["text"]
        for pat in _SELF_INTRO:
            for m in pat.finditer(text):
                vote(seg["speaker"], m.group(1), 3)
        for pat in _ADDRESSING:
            for m in pat.finditer(text):
                # addressed name belongs to a different speaker: next
                # different speaker in sequence, else the other of two
                target = None
                for j in range(i + 1, len(segs)):
                    if segs[j]["speaker"] != seg["speaker"]:
                        target = segs[j]["speaker"]
                        break
                if target is None and len(speakers) == 2:
                    target = next(
                        sp for sp in speakers if sp != seg["speaker"]
                    )
                if target:
                    vote(target, m.group(1), 1)

    out = {}
    used = set()
    for speaker in speakers:
        if speaker not in votes:
            continue
        for name, _ in votes[speaker].most_common():
            if name not in used:
                out[speaker] = name.title()
                used.add(name)
                break
    return out


def identify_speaker_names(segments, llm=None, config=None) -> dict:
    """LLM first, rules on failure (vocalis/core/audio_pipeline.py:506-521)."""
    names = {}
    try:
        names = identify_speaker_names_llm(segments, llm=llm, config=config)
    except Exception as e:
        logger.warning("LLM speaker naming failed: %s", e)
    if not names:
        names = identify_speaker_names_fallback(segments)
    return names


# ---------------------------------------------------------------------------
# Summaries and topics

_STOPWORDS = set(
    """a an the and or but if then else of in on at to for from with about as by
    is are was were be been being am do does did doing have has had having i
    you he she it we they me him her us them my your his its our their this
    that these those there here what which who whom when where why how not no
    yes so just very really quite too also can could will would shall should
    may might must let's im i'm it's dont don't didn't thats that's gonna got
    get like know think going go said say says well oh um uh yeah okay ok
    right now one two want need see look good time back out up down all some
    any more most other than only own same s t don won""".split()
)


def summarize_conversation(segments, llm=None, config: LLMConfig | None = None) -> str:
    """LLM summary (vocalis/llm/llm_helper.py:296-333) with an extractive
    fallback: the longest high-content turns in order."""
    config = config or LLMConfig()
    segs = list(segments)[: config.max_segments]
    if not segs:
        return ""
    convo = "\n".join(
        f"{s.get('speaker', '?')}: {s.get('text', '')}" for s in segs
    )
    out = generate_text(
        "Summarize this conversation in 2-3 sentences:\n\n" + convo
        + "\n\nSummary:",
        max_tokens=config.max_tokens_summary,
        temperature=config.temperature_summary, llm=llm,
    ).strip()
    if out:
        return out
    # extractive fallback: top-2 longest turns, chronological
    ranked = sorted(
        range(len(segs)), key=lambda i: -len(segs[i].get("text", ""))
    )[:2]
    picks = [segs[i] for i in sorted(ranked)]
    return " ".join(
        f"{s.get('speaker', '?')} said: {s.get('text', '').strip()}" for s in picks
    )


def extract_topics(segments, llm=None, config: LLMConfig | None = None,
                   max_topics: int = 5) -> list[str]:
    """LLM numbered-list topics (vocalis/llm/llm_helper.py:335-380) with a
    keyword-frequency fallback."""
    config = config or LLMConfig()
    segs = list(segments)[: config.max_segments]
    if not segs:
        return []
    convo = "\n".join(s.get("text", "") for s in segs)
    out = generate_text(
        "List the main topics of this conversation as a numbered list "
        "(max 5, 1-3 words each):\n\n" + convo + "\n\nTopics:\n1.",
        max_tokens=config.max_tokens_topics,
        temperature=config.temperature_summary, llm=llm,
    )
    topics = []
    for line in ("1." + out).splitlines():
        m = re.match(r"\s*\d+[.)]\s*(.+)", line)
        if m:
            t = m.group(1).strip().strip(".").strip()
            if t:
                topics.append(t)
    if topics:
        return topics[:max_topics]
    # fallback: most frequent content words
    words = re.findall(r"[a-zA-Z']{3,}", convo.lower())
    counts = Counter(w for w in words if w not in _STOPWORDS)
    return [w for w, c in counts.most_common(max_topics) if c >= 2]
