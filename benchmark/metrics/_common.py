"""Shared arithmetic of the per-layer readers: the card's peaks, or None
off a known card (a CPU run states no device number)."""

from __future__ import annotations

from typing import Dict, Optional

from benchmark.peaks import PEAKS


def card_peaks(record: Dict) -> Optional[Dict[str, float]]:
    return PEAKS.get(record.get('kind'))


def mean_ms(values) -> Optional[float]:
    v = [x for x in values if x is not None]
    return 1e3 * sum(v) / len(v) if v else None
