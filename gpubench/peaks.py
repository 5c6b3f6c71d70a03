"""Published peaks of the chips the benchmark runs on.

NVIDIA H100 SXM, data sheet, dense rates at the full 700 W power limit
(a card set below it runs slower: the run records its limit beside the
numbers). The 32-bit integer rate is 132 SMs x 128 lanes x 1.98 GHz
boost clock, the rate behind the sheet's 67 TFLOP/s float32 (a
multiply-add counted as two): each SM's four schedulers issue at most one
instruction per lane per clock, so no mix of integer instructions runs
faster (the figure ``chip_smoke.py`` divides by).
"""
from __future__ import annotations

H100 = {
    "int32_ops_per_s": 132 * 128 * 1.98e9,
    "hbm_bytes_per_s": 3.35e12,
}


def of(kind: str) -> dict:
    """The peaks of the card named ``kind`` (``torch.cuda.get_device_name``);
    an H100 of any memory or board name reads the SXM sheet."""
    if "H100" in kind:
        return H100
    raise KeyError(f"no published peaks for {kind!r}")
