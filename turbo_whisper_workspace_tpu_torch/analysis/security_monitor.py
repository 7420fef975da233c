"""Security/threat analysis over transcripts + incident reporting.

Port of turbo_whisper_workspace_tpu/analysis/security_monitor.py: the
same pattern banks, scoring, typing, context, summary and reports. The
monitor's default pipeline is this package's `get_pipeline` on its
`device` (CUDA unless the caller asks for the CPU), and the incident
summary comes from this package's LLM helper.

Rebuild of vocalis/security/security_monitor.py (410 LoC): regex pattern
banks scanned over merged transcript segments, an additive 1-5 threat
level, incident-type classification, ±1-segment context extraction, an
LLM incident summary with a transcript-dump fallback, JSON + human-
readable report files, and directory monitoring. The directory walk
feeds the batched pipeline instead of the reference's serial per-file
loop (vocalis/security/security_monitor.py:371-381).

Pattern banks are our own writing; categories and scoring semantics
match the reference (THREAT_PATTERNS/AGGRESSION_INDICATORS/
DRUG_INDICATORS at `:33-51`, threat math at `:232-261`, incident typing
at `:263-286`).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import re
import time
from dataclasses import dataclass, field

import torch

logger = logging.getLogger(__name__)

THREAT_PATTERNS = {
    "weapon": [
        r"\b(?:gun|pistol|rifle|firearm|glock|revolver)\b",
        r"\b(?:knife|blade|machete|switchblade)\b",
        r"\b(?:shoot|shooting|shot)\s+(?:him|her|you|them|up)\b",
        r"\bstrapped\b", r"\bpiece\s+on\s+me\b",
    ],
    "robbery": [
        r"\b(?:rob|robbing|robbery|stick\s*up|hold\s*up)\b",
        r"\bgive\s+me\s+(?:the|your)\s+(?:money|cash|wallet|register)\b",
        r"\bempty\s+the\s+(?:register|till|safe)\b",
        r"\bhand\s+(?:it|them|everything)\s+over\b",
    ],
    "violence": [
        r"\b(?:kill|murder|hurt|stab|beat)\s+(?:him|her|you|them|someone)\b",
        r"\bi'?ll\s+(?:kill|hurt|get)\s+you\b",
        r"\byou'?re\s+(?:dead|done|finished)\b",
        r"\bwatch\s+your\s+back\b",
        r"\bbreak\s+(?:his|her|your)\s+(?:legs|arms|neck|face)\b",
    ],
}

AGGRESSION_INDICATORS = [
    r"\b(?:fight|fighting|swing|punch|hit)\b",
    r"\bback\s+off\b", r"\bstep\s+outside\b",
    r"\bsay\s+that\s+again\b", r"\bwhat\s+did\s+you\s+(?:just\s+)?say\b",
    r"\bget\s+out\s+of\s+my\s+face\b", r"\byou\s+want\s+(?:some|this|to go)\b",
    r"\bcome\s+at\s+me\b",
]

DRUG_INDICATORS = [
    r"\b(?:cocaine|coke|heroin|meth|fentanyl|molly|ecstasy|pills)\b",
    r"\b(?:dealing|dealer|selling)\s+(?:drugs|dope|product)\b",
    r"\b(?:gram|eight\s*ball|baggie|dime\s*bag)\b",
    r"\bgot\s+(?:that\s+)?(?:stuff|product|supply)\s+on\s+me\b",
]


@dataclass
class SecurityIncident:
    """Incident record (reference SecurityIncident :56-111)."""

    timestamp: str
    audio_file: str
    threat_level: int                # 1-5
    incident_type: str
    matched_patterns: dict = field(default_factory=dict)
    relevant_segments: list = field(default_factory=list)
    summary: str = ""
    transcript_text: str = ""

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        lines = [
            "=" * 60,
            "SECURITY INCIDENT REPORT",
            "=" * 60,
            f"Time:          {self.timestamp}",
            f"Audio file:    {self.audio_file}",
            f"Threat level:  {self.threat_level}/5",
            f"Incident type: {self.incident_type}",
            "",
            "Matched patterns:",
        ]
        for cat, matches in self.matched_patterns.items():
            lines.append(f"  [{cat}] {', '.join(sorted(set(matches)))}")
        lines += ["", "Summary:", self.summary or "(none)", "",
                  "Relevant segments:"]
        for seg in self.relevant_segments:
            lines.append(
                f"  [{seg.get('start', 0):.1f}-{seg.get('end', 0):.1f}] "
                f"{seg.get('speaker', '?')}: {seg.get('text', '')}"
            )
        lines.append("=" * 60)
        return "\n".join(lines)


class SecurityMonitor:
    """Transcript threat analysis + full-pipeline audio monitoring
    (reference SecurityMonitor :114-381)."""

    pattern_banks: dict = {
        **THREAT_PATTERNS,
        "aggression": AGGRESSION_INDICATORS,
        "drugs": DRUG_INDICATORS,
    }

    def __init__(self, pipeline=None, min_threat_level: int = 2,
                 output_dir: str = "security_incidents",
                 device: torch.device | str = "cuda"):
        self._pipeline = pipeline
        self.min_threat_level = min_threat_level
        self.output_dir = output_dir
        self.device = device

    @property
    def pipeline(self):
        if self._pipeline is None:
            from ..pipeline.audio_pipeline import get_pipeline

            self._pipeline = get_pipeline(device=self.device)
        return self._pipeline

    # -- audio entry ------------------------------------------------------
    def process_audio_file(
        self, audio_path: str, min_threat_level: int | None = None,
    ) -> SecurityIncident | None:
        """Full pipeline (auto speaker count, reference :137-163) then
        transcript analysis; returns an incident above threshold.
        min_threat_level overrides the monitor default per call (the
        reference's SecurityRequest field, vocalis/api/main.py:56-58)."""
        result = self.pipeline.process_audio(audio_path, num_speakers=0)
        incident = self._analyze_transcript(
            result.get("merged_segments", []), audio_path,
            min_threat_level=min_threat_level,
        )
        if incident is not None:
            self._save_incident_report(incident)
        return incident

    def monitor_directory(self, directory: str, extensions=(".wav", ".flac", ".mp3")):
        """Directory batch → incidents. Files are transcribed as ONE
        batched pipeline call (vs the reference's serial loop :371-381)."""
        files = sorted(
            os.path.join(directory, f)
            for f in os.listdir(directory)
            if f.lower().endswith(tuple(extensions))
        )
        if not files:
            return []
        results = self.pipeline.process_batch(files, num_speakers=0)
        incidents = []
        for path, res in zip(files, results):
            inc = self._analyze_transcript(res.get("merged_segments", []), path)
            if inc is not None:
                self._save_incident_report(inc)
                incidents.append(inc)
        return incidents

    # -- analysis ---------------------------------------------------------
    def _find_pattern_matches(self, text: str, patterns) -> list[str]:
        found = []
        for pat in patterns:
            found += [m.group(0) for m in re.finditer(pat, text, re.IGNORECASE)]
        return found

    def _analyze_transcript(
        self, segments, audio_file: str = "",
        min_threat_level: int | None = None,
    ) -> SecurityIncident | None:
        """Scan → score → classify → context → summarize (reference :165-221)."""
        floor = (self.min_threat_level if min_threat_level is None
                 else min_threat_level)
        text = " ".join(s.get("text", "") for s in segments)
        matches = {}
        for cat, patterns in self.pattern_banks.items():
            found = self._find_pattern_matches(text, patterns)
            if found:
                matches[cat] = found
        level = self._calculate_threat_level(matches)
        if level < floor:
            return None
        incident = SecurityIncident(
            timestamp=time.strftime("%Y-%m-%d %H:%M:%S"),
            audio_file=audio_file,
            threat_level=level,
            incident_type=self._determine_incident_type(matches),
            matched_patterns=matches,
            relevant_segments=self._find_relevant_segments(segments, matches),
            transcript_text=text,
        )
        incident.summary = self._generate_incident_summary(incident)
        return incident

    def _calculate_threat_level(self, matches: dict) -> int:
        """Additive 1-5 (reference :232-261): weapons/violence weigh 2,
        robbery 2, drugs/aggression 1; capped at 5."""
        if not matches:
            return 0
        level = 1
        weights = {"weapon": 2, "violence": 2, "robbery": 2,
                   "aggression": 1, "drugs": 1}
        for cat in matches:
            level += weights.get(cat, 1)
        return min(level, 5)

    def _determine_incident_type(self, matches: dict) -> str:
        """Priority classification (reference :263-286)."""
        if "weapon" in matches:
            return "weapon_threat"
        if "robbery" in matches:
            return "robbery"
        if "violence" in matches:
            return "verbal_threat"
        if "drugs" in matches:
            return "drug_activity"
        if "aggression" in matches:
            return "aggressive_behavior"
        return "suspicious_activity"

    def _find_relevant_segments(self, segments, matches: dict) -> list[dict]:
        """Matching segments plus ±1 context neighbors (reference :288-314)."""
        all_terms = [t for terms in matches.values() for t in terms]
        hits = set()
        for i, seg in enumerate(segments):
            txt = seg.get("text", "").lower()
            if any(term.lower() in txt for term in all_terms):
                hits.update({i - 1, i, i + 1})
        return [segments[i] for i in sorted(hits) if 0 <= i < len(segments)]

    def _generate_incident_summary(self, incident: SecurityIncident) -> str:
        """LLM summary with transcript-dump fallback (reference :316-332)."""
        from ..llm import llm_helper

        prompt = (
            "Summarize this potential security incident in 2 sentences for "
            f"security staff. Type: {incident.incident_type}. Matched terms: "
            f"{incident.matched_patterns}. Transcript:\n"
            + "\n".join(
                f"{s.get('speaker', '?')}: {s.get('text', '')}"
                for s in incident.relevant_segments
            )
        )
        out = llm_helper.generate_text(prompt, max_tokens=128, temperature=0.2)
        if out.strip():
            return out.strip()
        cats = ", ".join(incident.matched_patterns)
        return (
            f"Potential {incident.incident_type.replace('_', ' ')} detected "
            f"(level {incident.threat_level}/5; categories: {cats}). "
            "Review the attached transcript segments."
        )

    # -- reporting --------------------------------------------------------
    def _save_incident_report(self, incident: SecurityIncident) -> tuple[str, str]:
        """JSON + human-readable txt (reference :334-349)."""
        os.makedirs(self.output_dir, exist_ok=True)
        stamp = time.strftime("%Y%m%d_%H%M%S")
        # second-resolution stamps collide when a directory batch yields
        # several incidents in one second (reference has the same flaw;
        # SURVEY §7.4 says fix, not port) — uniquify with a counter
        base = os.path.join(self.output_dir, f"incident_{stamp}")
        n = 0
        while os.path.exists(base + ".json"):
            n += 1
            base = os.path.join(self.output_dir, f"incident_{stamp}_{n}")
        json_path, txt_path = base + ".json", base + ".txt"
        with open(json_path, "w") as f:
            json.dump(incident.to_dict(), f, indent=2)
        with open(txt_path, "w") as f:
            f.write(str(incident))
        logger.info("incident saved: %s", txt_path)
        return json_path, txt_path


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="Security monitor")
    p.add_argument("--input", "-i", required=True, help="audio file or directory")
    p.add_argument("--output", "-o", default="security_incidents")
    p.add_argument("--min-threat-level", type=int, default=2)
    p.add_argument("--device", default="cuda",
                   help="torch device the models run on (default: cuda)")
    args = p.parse_args(argv)
    mon = SecurityMonitor(min_threat_level=args.min_threat_level,
                          output_dir=args.output, device=args.device)
    if os.path.isdir(args.input):
        incidents = mon.monitor_directory(args.input)
        print(f"{len(incidents)} incident(s) found")
    else:
        inc = mon.process_audio_file(args.input)
        print(str(inc) if inc else "no incident detected")


if __name__ == "__main__":
    main()
