"""Data-sheet peaks of the cards the benchmark runs on.

NVIDIA's H100 SXM data sheet, dense rates without sparsity, at the full
700 W power limit.  A card may be set below that limit; every run prints
the card's ``nvidia-smi`` name and power limit beside these numbers.  A
card not listed gets no share of a peak (its readers return nothing).
"""

from __future__ import annotations

import subprocess
from typing import Dict

PEAKS: Dict[str, Dict[str, float]] = {
    'NVIDIA H100 80GB HBM3': dict(bf16_flops=989e12, f32_flops=67e12,
                                  tf32_flops=495e12, hbm_bytes_s=3.35e12,
                                  power_w=700.0),
}


def card_line() -> str:
    """The first card's ``nvidia-smi`` name and power limit."""
    r = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                        '--format=csv,noheader'], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else \
        f'nvidia-smi failed: {r.stderr.strip()}'
