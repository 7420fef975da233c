"""Batch transcription: one caller, closed loop, each call
`Transcriber.transcribe(files)` on a call of the mix's pool (files whose
windows fill one bucket exactly).

Work of a call: the audio seconds of its files, each counted once.
"""

from __future__ import annotations

from port_bench.lib import asr, traffic, weights


class Entry(asr.Entry):
    def __init__(self, ctx):
        super().__init__(ctx)
        gen = weights.generator(ctx.seed, 1000, ctx.device)
        self.pool = [[traffic.speech(n, ctx.traffic["speech"], gen, ctx.device) for n in files]
                     for files in traffic.batch_calls(ctx.traffic)]

    def files(self, k: int) -> list:
        return self.pool[k]

    def run(self, k: int) -> None:
        out = self.tr.transcribe(self.pool[k])
        if len(out) != len(self.pool[k]):
            raise RuntimeError(f"{len(out)} results for {len(self.pool[k])} files")

    def warm_up(self) -> None:
        self.run(0)
        self.tap.take()
