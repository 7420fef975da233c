"""Bar-specific security monitoring.

Port of turbo_whisper_workspace_tpu/analysis/bar_security_monitor.py, on
this package's SecurityMonitor (with its `device`).

Rebuild of vocalis/security/bar_security_monitor.py (279 LoC):
`BarSecurityMonitor(SecurityMonitor)` adds bar-context pattern banks
(`:32-53`), a threat calculation that bumps for heavy intoxication and
any underage signal (`:144-176`), priority incident types
(underage/intoxication first, `:178-223`), a bar directory monitor
(`:226-255`), and the legacy mock-transcript test mode
(bar_security_monitor.py:522-585) — the only fake-backend pattern the
reference ships, kept here as `run_mock_analysis`.
"""

from __future__ import annotations

import json
import os

import torch

from .security_monitor import SecurityIncident, SecurityMonitor

BAR_SPECIFIC_PATTERNS = {
    "overservice": [
        r"\b(?:another|one more)\s+(?:round|shot|drink)\b.*\b(?:cut\s*off|too\s+many)\b",
        r"\bhe'?s\s+had\s+(?:enough|too\s+many)\b",
        r"\bstop\s+serving\s+(?:him|her|them)\b",
    ],
    "altercation": [
        r"\b(?:bouncer|security)\b.*\b(?:now|quick|here)\b",
        r"\bthrow\s+(?:him|her|them)\s+out\b",
        r"\b(?:bar\s*fight|brawl)\b",
        r"\bbroke\s+a\s+(?:bottle|glass)\s+(?:on|over)\b",
    ],
}

INTOXICATION_INDICATORS = [
    r"\b(?:wasted|hammered|plastered|blackout|blacked\s+out)\b",
    r"\bcan'?t\s+(?:stand|walk|see)\s+straight\b",
    r"\b(?:slurring|stumbling|passed\s+out)\b",
    r"\bway\s+too\s+drunk\b",
    r"\bthrow(?:ing)?\s+up\b",
]

UNDERAGE_INDICATORS = [
    r"\b(?:fake\s+i\.?d\.?|borrowed\s+i\.?d\.?)\b",
    r"\b(?:underage|minor)\b",
    r"\b(?:only|just|i'?m)\s+(?:seventeen|eighteen|17|18|19|20)\b",
    r"\bdon'?t\s+(?:have|got)\s+(?:an?\s+)?i\.?d\.?\b",
    r"\bmy\s+older\s+(?:brother|sister)'?s?\s+i\.?d\.?\b",
]


class BarSecurityMonitor(SecurityMonitor):
    def __init__(self, pipeline=None, min_threat_level: int = 2,
                 output_dir: str = "bar_analysis",
                 device: torch.device | str = "cuda"):
        super().__init__(pipeline=pipeline, min_threat_level=min_threat_level,
                         output_dir=output_dir, device=device)
        self.pattern_banks = {
            **SecurityMonitor.pattern_banks,
            **BAR_SPECIFIC_PATTERNS,
            "intoxication": INTOXICATION_INDICATORS,
            "underage": UNDERAGE_INDICATORS,
        }

    def _calculate_threat_level(self, matches: dict) -> int:
        """Base calc + intoxication>2 bump + underage bump
        (reference :144-176)."""
        base_matches = {
            k: v for k, v in matches.items()
            if k not in ("intoxication", "underage")
        }
        level = super()._calculate_threat_level(base_matches)
        if len(matches.get("intoxication", [])) > 2:
            level = max(level, 1) + 1
        if matches.get("underage"):
            level = max(level, 2) + 1
        return min(level, 5)

    def _determine_incident_type(self, matches: dict) -> str:
        """Underage/intoxication take priority (reference :178-223)."""
        if "underage" in matches:
            return "underage_drinking"
        if len(matches.get("intoxication", [])) > 2:
            return "severe_intoxication"
        if "overservice" in matches:
            return "overservice"
        if "altercation" in matches:
            return "bar_altercation"
        return super()._determine_incident_type(matches)

    def monitor_bar_directory(self, directory: str, **kw):
        return self.monitor_directory(directory, **kw)


def run_mock_analysis(mock_json_path: str | None = None,
                      monitor: BarSecurityMonitor | None = None):
    """Analyze a mock transcript JSON, bypassing audio/ASR entirely —
    the reference's --test harness (bar_security_monitor.py:522-560)."""
    monitor = monitor or BarSecurityMonitor()
    if mock_json_path and os.path.exists(mock_json_path):
        with open(mock_json_path) as f:
            segments = json.load(f)
    else:
        segments = [
            {"speaker": "Speaker 0", "text": "He's had way too many, "
                                             "stop serving him.", "start": 0.0,
             "end": 3.0},
            {"speaker": "Speaker 1", "text": "Dude is totally wasted, he "
                                             "can't walk straight and he's "
                                             "slurring.", "start": 3.0,
             "end": 6.0},
            {"speaker": "Speaker 0", "text": "And that kid showed a fake ID, "
                                             "he's underage.", "start": 6.0,
             "end": 9.0},
        ]
    return monitor._analyze_transcript(segments, audio_file="<mock>")


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="Bar security monitor")
    p.add_argument("--input", "-i", help="audio file or directory")
    p.add_argument("--output", "-o", default="bar_analysis")
    p.add_argument("--min-threat-level", type=int, default=2)
    p.add_argument("--test", action="store_true",
                   help="run on a built-in mock transcript (no audio)")
    p.add_argument("--mock-json", help="mock transcript JSON path")
    p.add_argument("--device", default="cuda",
                   help="torch device the models run on (default: cuda)")
    args = p.parse_args(argv)
    mon = BarSecurityMonitor(min_threat_level=args.min_threat_level,
                             output_dir=args.output, device=args.device)
    if args.test or not args.input:
        inc = run_mock_analysis(args.mock_json, mon)
        print(str(inc) if inc else "no incident in mock data")
        return
    if os.path.isdir(args.input):
        incidents = mon.monitor_bar_directory(args.input)
        print(f"{len(incidents)} incident(s) found")
    else:
        inc = mon.process_audio_file(args.input)
        print(str(inc) if inc else "no incident detected")


if __name__ == "__main__":
    main()
