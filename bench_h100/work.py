"""The least work of a frame and of a training step, counted from shapes
and from the plain reference's pair counts, and the card's peaks.

After vegs_torch/perf/roofline.py, with its per-pair and per-Gaussian
operation counts, changed in what is counted: only what these inputs need.
A pair is counted where alpha reaches 1/255 before its pixel stops
(`tested`, the stopping pair included) or where it is blended
(`included`); an instance (a Gaussian's tile) only where one of its pairs
is tested (`slots`). The walk a kernel makes over the rest of its tile,
and the saturation prepass (K4), are the program's choice and are not
counted.

Peaks of one H100 SXM (NVIDIA's data sheet, 700 W): 3.35 TB/s of HBM,
67 TFLOP/s of float32 outside the tensor cores."""

from __future__ import annotations

from typing import NamedTuple

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12

OPS_TESTED = 18 + 5
OPS_INCLUDED = {"K1": 27, "K2": 72}
PARAM_BYTES = (3 + 4 + 3 + 48 + 1) * 4   # means, quats, scales, SH, opacity
PROJECTED_BYTES = 53
BIN_IN_BYTES = 36
PROJECT_OPS_FWD, PROJECT_OPS_BWD = 300, 600
ROW_BYTES = 8 * 4                          # an instance's f32 payload row
AUX = {"bf16": 2, "f32": 4}
SSIM_TAPS = 121


class Work(NamedTuple):
    bytes: float
    ops: float

    def __add__(self, o):
        return Work(self.bytes + o.bytes, self.ops + o.ops)

    def seconds(self) -> float:
        return max(self.bytes / PEAK_BYTES_PER_S, self.ops / PEAK_F32_PER_S)


def k1(pairs: dict, aux_bytes: int, pixels: int) -> Work:
    """Blend forward: the used payload rows, the [12, pixels] output."""
    return Work(pairs["slots"] * (7 * 4 + 10 * aux_bytes) + 12 * 4 * pixels,
                pairs["tested"] * OPS_TESTED
                + pairs["included"] * OPS_INCLUDED["K1"])


def k2(pairs: dict, aux_bytes: int, pixels: int) -> Work:
    """Blend backward: K1's reads, the output and its cotangent, the
    gradient rows of the used instances."""
    return Work(pairs["slots"] * (7 * 4 + 10 * aux_bytes)
                + pairs["slots"] * (8 * 4 + 16 * aux_bytes)
                + 2 * 12 * 4 * pixels,
                pairs["tested"] * OPS_TESTED
                + pairs["included"] * OPS_INCLUDED["K2"])


def frame(n: int, pairs: dict, aux: str, pixels: int) -> Work:
    """A rendered frame: projection, binning of the used instances, the
    payload gather, the blend, the rgb copied out (4 bytes a channel)."""
    ab = AUX[aux]
    row = ROW_BYTES + 16 * ab
    return (Work(n * (PARAM_BYTES + PROJECTED_BYTES), n * PROJECT_OPS_FWD)
            + Work(n * BIN_IN_BYTES + 8 * pairs["slots"], 0)
            + Work(2 * pairs["slots"] * row, 0)
            + k1(pairs, ab, pixels)
            + Work(2 * 3 * 4 * pixels, 0))


def step(n: int, pairs: dict, aux: str, pixels: int) -> Work:
    """A training step: the frame's forward, the losses (L1, SSIM's five
    filtered maps forward and back, the normal loss), the blend's and the
    gather's backward, the projection's backward, Adam's read of
    parameters, gradients and moments and write of parameters and moments,
    and the densification statistics."""
    ab = AUX[aux]
    row = ROW_BYTES + 16 * ab
    param = PARAM_BYTES
    losses = Work(3 * 4 * pixels * 14 + 7 * 4 * pixels * 2,
                  3 * pixels * (5 * 2 * SSIM_TAPS * 3 + 40) + pixels * 200)
    gather_bwd = Work(pairs["slots"] * (row + 4) + n * row, 24 * pairs["slots"])
    project_bwd = Work(n * (param + PROJECTED_BYTES + param), n * PROJECT_OPS_BWD)
    adam = Work(n * param * 7, n * (param // 4) * 12)
    stats = Work(n * (8 + 3 * 4 * 2 + 4), n * 6)
    return (frame(n, pairs, aux, pixels) + losses
            + k2(pairs, ab, pixels) + gather_bwd + project_bwd + adam + stats)
