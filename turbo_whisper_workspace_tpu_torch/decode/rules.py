"""Whisper decode-time logit constraints as masks on torch tensors.

Port of turbo_whisper_workspace_tpu/decode/rules.py. The openai/whisper
grammar, as vectorised masks over the (B, V) logits:

* static suppress list (non-speech tokens + control specials);
* begin-suppress (blank / EOT cannot open a segment);
* timestamp pairing: after <|t|><|t|> the next token must be text;
  after a single <|t|> only a timestamp or EOT may follow;
* timestamps are monotonically non-decreasing within a window;
* the first sampled token must be a timestamp, capped at
  max_initial_timestamp (1.0 s);
* if the total timestamp probability mass beats the best text token,
  a timestamp must be emitted.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .tokenizer import SpecialTokens

# Canonical non-speech suppress list for the published multilingual
# vocabularies (same content HF ships in generation_config.suppress_tokens).
CANONICAL_SUPPRESS = (
    1, 2, 7, 8, 9, 10, 14, 25, 26, 27, 28, 29, 31, 58, 59, 60, 61, 62, 63,
    90, 91, 92, 93, 359, 503, 522, 542, 873, 893, 902, 918, 922, 931, 1350,
    1853, 1982, 2460, 2627, 3246, 3253, 3268, 3536, 3846, 3961, 4183, 4667,
    6585, 6647, 7273, 9061, 9383, 10428, 10929, 11938, 12033, 12331, 12562,
    13793, 14157, 14635, 15265, 15618, 16553, 16604, 18362, 18956, 20075,
    21675, 22520, 26130, 26161, 26435, 28279, 29464, 31650, 32302, 32470,
    36865, 42863, 47425, 49870, 50254,
)

NEG_INF = -1e30  # finite -inf: keeps masked softmax NaN-free


@dataclass(frozen=True)
class DecodeRules:
    specials: SpecialTokens
    timestamps: bool = True
    max_initial_timestamp_s: float = 1.0
    extra_suppress: tuple = ()

    def _static_suppress_ids(self) -> np.ndarray:
        sp = self.specials
        ids = {sp.sot, sp.sot_prev, sp.sot_lm, sp.no_speech, sp.translate,
               sp.transcribe}
        ids.update(sp.language_tokens.values())
        ids.add(sp.no_timestamps)
        ids.update(i for i in self.extra_suppress if i < sp.n_vocab)
        if sp.n_vocab >= 51864:
            ids.update(i for i in CANONICAL_SUPPRESS if i < sp.n_vocab)
        return np.array(sorted(ids), dtype=np.int64)

    def static_mask(self, device: torch.device | str = "cpu") -> torch.Tensor:
        """(V,) additive mask applied at every step."""
        mask = np.zeros((self.specials.n_vocab,), np.float32)
        mask[self._static_suppress_ids()] = NEG_INF
        return torch.from_numpy(mask).to(device)

    def begin_mask(self, device: torch.device | str = "cpu") -> torch.Tensor:
        """(V,) additive mask for the first sampled position only."""
        sp = self.specials
        mask = np.zeros((sp.n_vocab,), np.float32)
        # blank (" " = GPT-2 id 220) and EOT cannot begin a segment
        if sp.n_vocab > 220:
            mask[220] = NEG_INF
        mask[sp.eot] = NEG_INF
        if self.timestamps:
            # first token must be a timestamp, capped at max_initial
            mask[: sp.timestamp_begin] = NEG_INF
            cap = sp.timestamp_begin + int(self.max_initial_timestamp_s / 0.02) + 1
            if cap < sp.n_vocab:
                mask[cap:] = NEG_INF
        return torch.from_numpy(mask).to(device)

    def apply(
        self,
        logits: torch.Tensor,        # (B, V) f32
        is_begin: bool,              # first sampled position?
        last_tok: torch.Tensor,      # (B,) previous sampled token
        penult_tok: torch.Tensor,    # (B,) token before that
        ts_floor: torch.Tensor,      # (B,) minimum allowed timestamp token id
        static_mask: torch.Tensor,
        begin_mask: torch.Tensor,
    ) -> torch.Tensor:
        sp = self.specials
        v = sp.n_vocab
        logits = logits + static_mask[None]
        if is_begin:
            logits = logits + begin_mask[None]
        if not self.timestamps:
            ts_mask = torch.zeros(v, device=logits.device)
            ts_mask[sp.timestamp_begin:] = NEG_INF
            return logits + ts_mask[None]

        token_ids = torch.arange(v, device=logits.device)
        is_ts_tok = token_ids >= sp.timestamp_begin        # (V,)
        if not is_begin:                                   # begin_mask governs step 0
            is_text_tok = token_ids < sp.eot
            last_is_ts = last_tok >= sp.timestamp_begin    # (B,)
            penult_is_ts = penult_tok >= sp.timestamp_begin
            # after <|t|><|t|> → no more timestamps; after single <|t|> → no text
            ban_ts = (last_is_ts & penult_is_ts)[:, None] & is_ts_tok[None]
            ban_text = (last_is_ts & ~penult_is_ts)[:, None] & is_text_tok[None]
            # monotonicity: timestamps below the floor are banned
            ban_low = is_ts_tok[None] & (token_ids[None] < ts_floor[:, None])
            logits = logits.masked_fill(ban_ts | ban_text | ban_low, NEG_INF)

        # timestamp-probability rule on raw masked logits: logp = logits -
        # lse(row) shifts both sides of the comparison by the same constant
        ts_lse = torch.logsumexp(logits.masked_fill(~is_ts_tok[None], NEG_INF), dim=-1)
        max_text = logits.masked_fill(is_ts_tok[None], NEG_INF).amax(dim=-1)
        force_ts = ts_lse > max_text                       # (B,)
        return logits.masked_fill(force_ts[:, None] & ~is_ts_tok[None], NEG_INF)


def update_ts_floor(ts_floor: torch.Tensor, next_tok: torch.Tensor,
                    prev_tok: torch.Tensor, sp: SpecialTokens) -> torch.Tensor:
    """New minimum-allowed timestamp id after sampling next_tok.

    Mirrors openai/whisper's timestamp_last bookkeeping: a timestamp that
    follows text keeps an *inclusive* floor (the adjacent pair token may
    repeat the same value); a timestamp following a timestamp moves the
    floor past itself; and once text follows a timestamp the floor bumps
    past that timestamp (segment ends are strictly greater than starts).
    """
    tsb = sp.timestamp_begin
    is_ts = next_tok >= tsb
    prev_is_ts = prev_tok >= tsb
    floor = ts_floor
    floor = torch.where(is_ts & ~prev_is_ts, torch.maximum(floor, next_tok), floor)
    floor = torch.where(is_ts & prev_is_ts, torch.maximum(floor, next_tok + 1), floor)
    floor = torch.where(~is_ts & prev_is_ts, torch.maximum(floor, prev_tok + 1), floor)
    return floor
