"""Speed-of-light bounds of the rasterizer's stages on one H100: port of
perf/r10_roofline.py.

For each stage that `refscale` times: the bytes it must move (each input
read once, each output written once), the fp32 operations it must do, its
bound max(bytes / 3.35 TB/s, operations / 67 TFLOP/s), its times measured
in the same run (the stream's, and the card's own), and the share bound /
time of each. The counts are the port's work at
this run's sizes: the blend kernels charge operations per walked, tested
and included (pixel, instance) pair from the plain versions' `pairs`
record, the segment reduce one add per column element; the sort has no
bound and is reported against its time, as r10 does. A share above 100%
means a count is wrong, and the run fails. No time taken on a TPU enters:
r10's `MEASURED_2M` is not carried over.

Run on the card:  python -m vegs_torch.perf.roofline
(runs `refscale` with its settings, then one JSON line per stage)
"""

from __future__ import annotations

import json
from typing import NamedTuple

# Peaks of one H100 SXM (NVIDIA data sheet, at its 700 W limit): HBM
# bandwidth, and the fp32 rate outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12

# fp32 operations (an FMA is two, exp and log1p one each) per (pixel,
# instance) pair, by how far the walk takes the pair:
#   walked   -- alpha (csrc/splat.cuh splat_alpha): offsets 2, quadratic
#               form 9, clamp/exp/opacity 3, the two tests, clamp and zero
#               test 4;
#   tested   -- alpha > 0: T from log T 2, the stop test 3;
#   included -- K1: the weight 1, 11 channel FMAs 22, the log-T update 4;
#               K4: the log-T update 4;
#               K2: the weight 1, dw 22, the suffix sum 2, dL 1, dalpha 4,
#               the clamp test and dpower 2, six monomials 6, dop 1, eleven
#               channel products 11, the log-T update 4, and the 18 values
#               summed over the tile's pixels 18.
OPS_WALKED, OPS_TESTED = 18, 5
OPS_INCLUDED = {"K1": 27, "K2": 72, "K4": 4}

# Per Gaussian: the parameters the projection reads (means 12, quats 16,
# scales 12, opacity 4, SH 16 x 3 x 4 at degree 3) and the `Projected` it
# writes (means2d 8, depths 4, conics 12, radii 4, rgb 12, opacities 4,
# visible 1, radii_xy 8); binning reads means2d, depths, radii_xy, conics
# and opacities.
PROJECTED_BYTES = 53
BIN_IN_BYTES = 36
# fp32 operations per Gaussian of the projection, an estimate: the
# covariance from scale and rotation ~60, the EWA projection and conic
# ~120, the SH colour at degree 3 ~120; the backward about twice that.
PROJECT_OPS_FWD, PROJECT_OPS_BWD = 300, 600


class Work(NamedTuple):
    bytes: int
    ops: int

    def __add__(self, other):
        return Work(self.bytes + other.bytes, self.ops + other.ops)


def bound_ms(w: Work) -> tuple[float, str]:
    """The least time of `w` on the card, and what binds it."""
    b_ms = w.bytes / PEAK_BYTES_PER_S * 1e3
    o_ms = w.ops / PEAK_F32_PER_S * 1e3
    return max(b_ms, o_ms), ("bytes" if b_ms >= o_ms else "operations")


def pair_ops(pairs: dict, kernel: str) -> int:
    return (pairs["walked"] * OPS_WALKED + pairs["tested"] * OPS_TESTED
            + pairs["included"] * OPS_INCLUDED[kernel])


def k1_work(pairs, aux_bytes, num_tiles, hp, wp) -> Work:
    """K1: the rows it uses (7 f32, 10 aux) of the instances up to each
    tile's farthest stop, the ranges, the [12, hp, wp] f32 output."""
    return Work(pairs["slots"] * (7 * 4 + 10 * aux_bytes)
                + 4 * (num_tiles + 1) + 12 * 4 * hp * wp,
                pair_ops(pairs, "K1"))


def k2_work(pairs, aux_bytes, k, num_tiles, hp, wp) -> Work:
    """K2: K1's reads, the forward output and its cotangent, and the
    gradient rows of all k slots (8 f32, 16 aux)."""
    return Work(pairs["slots"] * (7 * 4 + 10 * aux_bytes)
                + k * (8 * 4 + 16 * aux_bytes)
                + 2 * 12 * 4 * hp * wp + 4 * (num_tiles + 1),
                pair_ops(pairs, "K2"))


def k3_work(rows, columns, segments) -> Work:
    """K3: the summed f32 columns, the segment bounds, the sums; one add
    per column element."""
    return Work(4 * (rows * (columns + segments) + 2 * segments),
                rows * columns)


def k4_work(pairs, num_tiles) -> Work:
    """K4: the 6 f32 rows it reads of the in-range instances up to each
    tile's farthest crossing, the ranges, the counts."""
    return Work(pairs["slots"] * 6 * 4 + 4 * (2 * num_tiles + 1),
                pair_ops(pairs, "K4"))


def stage_work(c: dict) -> dict:
    """Work of each stage `refscale` times (by its name), from its counts
    `c`; the sort maps to None (no bound)."""
    n, kc, kp, t = c["n"], c["k_cap"], c["k_pad"], c["tiles"]
    es = c["aux_bytes"]
    params = 12 + 16 + 12 + 4 + c["sh_coeffs"] * 3 * 4
    proj_fwd = Work(n * (params + PROJECTED_BYTES), n * PROJECT_OPS_FWD)
    proj_fb = Work(n * (2 * params + PROJECTED_BYTES),
                   n * (PROJECT_OPS_FWD + PROJECT_OPS_BWD))
    bin_raw = Work(n * (BIN_IN_BYTES + 4) + 16 * kc + 4 * (t + 1), 0)
    bin_g = Work(n * (BIN_IN_BYTES + 4) + 4 * kp + 4 * kc + 4 * (t + 1), 0)
    prepass = Work(32 * (n + 1) + 4 * kc + 32 * kc, 0)
    k4 = k4_work(c["pairs_k4"], t)
    row = 32 + 16 * es  # one Gaussian's f32 and aux payload rows
    ge_fwd = Work((n + 1) * row + 4 * kp + kp * row, 0)
    k3 = k3_work(24, c["columns"], n + 1)
    k1 = k1_work(c["pairs_k1"], es, t, c["hp"], c["wp"])
    k2 = k2_work(c["pairs_k1"], es, kp, t, c["hp"], c["wp"])
    sat = (prepass + k4) if c["sat"] else Work(0, 0)
    return {
        "[16x16] full fwd+bwd": proj_fb + bin_raw + sat + ge_fwd + k3 + k1 + k2,
        "[16x16] full forward": proj_fwd + bin_raw + sat + ge_fwd + k1,
        "project (+cov6) fwd+bwd": proj_fb,
        "bin_gaussians (grad maps, no keys)": bin_g,
        "bin_raw (expand+cull+sort)": bin_raw,
        "sort at k_cap (stable, 2 gathers)": None,
        "satcull prepass gather": prepass,
        "K4 satcount": k4,
        "GatherExpand fwd": ge_fwd,
        "GatherExpand fwd+bwd (K3)": ge_fwd + k3,
        "K1 blend fwd": k1,
        "K1+K2 blend fwd+bwd": k1 + k2,
    }


def table(result: dict, emit=None) -> list[dict]:
    """One row per timed stage of a `refscale.run(..., work=True)` result:
    bytes, operations, bound, measured ms and share -- of the stream time
    ("share") and of the card's own time ("device_share"). Raises if a
    share exceeds 1."""
    emit = emit or (lambda **kw: print(json.dumps(kw), flush=True))
    works = stage_work(result["counts"])
    rows = []
    for name, t in result["stages"].items():
        if name not in works:
            continue
        w = works[name]
        row = {"stage": name, **{k: v for k, v in t.items() if k != "top"}}
        if w is not None:
            b, by = bound_ms(w)
            row.update(bytes=w.bytes, ops=w.ops, bound_ms=b, bound_by=by)
            for share, ms in (("share", "ms"), ("device_share", "device_ms")):
                if ms in t:
                    row[share] = b / t[ms]
        emit(**row, card=result["card"])
        rows.append(row)
    over = [r for r in rows
            if max(r.get("share", 0), r.get("device_share", 0)) > 1]
    if over:
        raise AssertionError(f"a stage runs faster than its bound: a count "
                             f"is wrong: {over}")
    return rows


def main() -> None:
    from . import refscale

    table(refscale.run(**refscale.env_settings(), work=True))


if __name__ == "__main__":
    main()
