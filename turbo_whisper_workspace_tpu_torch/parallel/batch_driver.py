"""Multi-process directory batch driver with resume + failure accounting.

Port of turbo_whisper_workspace_tpu/parallel/batch_driver.py. A
directory job is: discover → shard files across processes (round-robin
by the torch.distributed rank, where the JAX package takes its process
index) → per-process batched pipeline calls → per-file JSON artifacts +
a done-manifest for resume → failure isolation (a failing file is
recorded and skipped, never kills the job). Without a process group the
driver is rank 0 of 1. The pipeline it builds runs on the driver's
device (CUDA unless `device="cpu"`).
"""

from __future__ import annotations

import json
import logging
import os
import time
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

AUDIO_EXTS = (".wav", ".flac", ".mp3")


def _rank_and_world() -> tuple[int, int]:
    """This process's rank and the world size, or (0, 1) with no group."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


@dataclass
class BatchStats:
    processed: int = 0
    skipped: int = 0
    failed: int = 0
    audio_seconds: float = 0.0
    wall_seconds: float = 0.0
    failures: list = field(default_factory=list)

    @property
    def audio_s_per_s(self) -> float:
        return self.audio_seconds / self.wall_seconds if self.wall_seconds else 0.0

    def to_dict(self) -> dict:
        return {
            "processed": self.processed, "skipped": self.skipped,
            "failed": self.failed, "audio_seconds": self.audio_seconds,
            "wall_seconds": self.wall_seconds,
            "audio_s_per_s": self.audio_s_per_s, "failures": self.failures,
        }


class BatchDriver:
    def __init__(self, pipeline=None, output_dir: str = "batch_output",
                 files_per_call: int = 8, max_retries: int = 1,
                 device: torch.device | str = "cuda"):
        self._pipeline = pipeline
        self.output_dir = output_dir
        self.files_per_call = files_per_call
        self.max_retries = max_retries
        self.device = device

    @property
    def pipeline(self):
        if self._pipeline is None:
            from ..pipeline.audio_pipeline import get_pipeline

            self._pipeline = get_pipeline(device=self.device)
        return self._pipeline

    # -- manifest ---------------------------------------------------------
    def _manifest_path(self) -> str:
        return os.path.join(self.output_dir,
                            f"manifest_host{_rank_and_world()[0]}.json")

    def _load_done(self) -> set:
        try:
            with open(self._manifest_path()) as f:
                return set(json.load(f)["done"])
        except Exception:
            return set()

    def _save_done(self, done: set) -> None:
        os.makedirs(self.output_dir, exist_ok=True)
        with open(self._manifest_path(), "w") as f:
            json.dump({"done": sorted(done)}, f)

    # -- sharding ---------------------------------------------------------
    @staticmethod
    def shard_files(files: list[str]) -> list[str]:
        """Round-robin shard over participating processes."""
        i, n = _rank_and_world()
        return files[i::n]

    # -- main -------------------------------------------------------------
    def run_directory(self, directory: str, num_speakers: int = 0,
                      enrich: bool = True) -> BatchStats:
        from .infer import maybe_initialize_distributed

        maybe_initialize_distributed(self.device)  # no-op on one process
        files = sorted(
            os.path.join(directory, f)
            for f in os.listdir(directory)
            if f.lower().endswith(AUDIO_EXTS)
        )
        files = self.shard_files(files)
        done = self._load_done()
        todo = [f for f in files if f not in done]

        stats = BatchStats(skipped=len(files) - len(todo))
        t0 = time.time()
        os.makedirs(self.output_dir, exist_ok=True)

        for lo in range(0, len(todo), self.files_per_call):
            chunk = todo[lo : lo + self.files_per_call]
            results = self._process_with_isolation(chunk, num_speakers, enrich)
            for path, res in zip(chunk, results):
                if res is None:
                    stats.failed += 1
                    stats.failures.append(path)
                    continue
                base = os.path.splitext(os.path.basename(path))[0]
                with open(os.path.join(self.output_dir, base + ".json"), "w") as f:
                    json.dump(res, f, indent=1, default=str)
                stats.processed += 1
                stats.audio_seconds += res.get("duration", 0.0)
                done.add(path)
            self._save_done(done)

        stats.wall_seconds = time.time() - t0
        logger.info(
            "batch done: %d processed, %d skipped, %d failed, %.1f audio-s/s",
            stats.processed, stats.skipped, stats.failed, stats.audio_s_per_s,
        )
        return stats

    def _process_with_isolation(self, chunk, num_speakers, enrich):
        """Batch call; transient retries at the full-chunk level, then
        BISECT to isolate poisoned inputs in O(log n) calls. Halves of a
        power-of-two chunk reuse the transcriber's decode batch buckets."""
        for attempt in range(self.max_retries + 1):
            try:
                return self.pipeline.process_batch(
                    chunk, num_speakers=num_speakers, enrich=enrich
                )
            except Exception as e:
                logger.warning("batch of %d failed (attempt %d): %s",
                               len(chunk), attempt + 1, e)
        if len(chunk) == 1:
            logger.error("file failed permanently: %s", chunk[0])
            return [None]
        mid = (len(chunk) + 1) // 2
        return (self._bisect(chunk[:mid], num_speakers, enrich)
                + self._bisect(chunk[mid:], num_speakers, enrich))

    def _bisect(self, chunk, num_speakers, enrich):
        try:
            return self.pipeline.process_batch(
                chunk, num_speakers=num_speakers, enrich=enrich
            )
        except Exception as e:
            if len(chunk) == 1:
                logger.error("file failed permanently: %s (%s)", chunk[0], e)
                return [None]
            mid = (len(chunk) + 1) // 2
            return (self._bisect(chunk[:mid], num_speakers, enrich)
                    + self._bisect(chunk[mid:], num_speakers, enrich))
