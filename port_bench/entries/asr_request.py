"""Single-file requests: one client, closed loop, each call
`AudioProcessingPipeline.transcribe(path)` on a 16-bit WAV file the
set-up wrote under TMPDIR (the pipeline reads and decodes it, then one
transcriber call takes its 1-6 windows in a bucket of 1, 2, 4 or 8).

Work of a call: the request's audio seconds; its latency is the host
clock from the call to its return.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import wave

import numpy as np

from port_bench.lib import asr, traffic, weights


def write_wav(path: str, audio: np.ndarray) -> None:
    pcm = np.clip(np.round(audio * 32767.0), -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(traffic.SAMPLE_RATE)
        f.writeframes(pcm.tobytes())


def read_wav(path: str) -> np.ndarray:
    """The file as the pipeline reads it: 16-bit samples / 32768, scaled
    to a peak of 1."""
    with wave.open(path, "rb") as f:
        x = np.frombuffer(f.readframes(f.getnframes()), dtype="<i2").astype(np.float32)
    x /= 32768.0
    peak = float(np.abs(x).max())
    return x / peak if peak > 0 else x


class Entry(asr.Entry):
    def __init__(self, ctx):
        from turbo_whisper_workspace_tpu_torch.config import PipelineConfig
        from turbo_whisper_workspace_tpu_torch.pipeline.audio_pipeline import (
            AudioProcessingPipeline)

        super().__init__(ctx)
        self.pipe = AudioProcessingPipeline(PipelineConfig(transcription=self.tr.config),
                                            transcriber=self.tr, device=ctx.device)
        self.dir = tempfile.mkdtemp(prefix="port_bench_requests_")
        gen = weights.generator(ctx.seed, 1000, ctx.device)
        self.paths, self.lengths = [], traffic.request_lengths(ctx.traffic)
        for i, n in enumerate(self.lengths):
            path = os.path.join(self.dir, f"request_{i:03d}.wav")
            write_wav(path, traffic.speech(n, ctx.traffic["speech"], gen, ctx.device))
            self.paths.append(path)
        self.pool = self.paths

    def files(self, k: int) -> list:
        return [read_wav(self.paths[k])]

    def windows(self, k: int) -> int:
        return traffic.n_windows(self.lengths[k])

    def audio_s(self, k: int) -> float:
        return self.lengths[k] / traffic.SAMPLE_RATE

    def run(self, k: int) -> None:
        out = self.pipe.transcribe(self.paths[k])
        if "segments" not in out:
            raise RuntimeError(f"request {k}: no segments in the result")

    def warm_up(self) -> None:
        """One request of each bucket size the pool uses."""
        seen = set()
        for k in range(len(self.paths)):
            w = self.windows(k)
            bucket = 1 << (w - 1).bit_length()
            if bucket not in seen:
                seen.add(bucket)
                self.run(k)
        self.tap.take()

    def chosen_calls(self, calls, rng) -> list:
        """The request with the most windows, and others drawn from the seed."""
        longest = max(range(len(calls)), key=lambda i: self.windows(calls[i].pool))
        rest = [i for i in range(len(calls)) if i != longest]
        n = min(self.ctx.cell["check_calls"] - 1, len(rest))
        return sorted([longest, *(int(i) for i in rng.choice(rest, size=n, replace=False))])

    def close(self) -> None:
        shutil.rmtree(self.dir, ignore_errors=True)
