"""Alpha-compositing spec oracles (port of vegs_tpu/ops/blend_ref.py).

Compositing spec (per pixel p in tile t, instances i in (tile, depth)-sorted
order restricted to tile t):
    power_i = -0.5*(a_i dx^2 + c_i dy^2) - b_i dx dy,  d = p - mean2d_i
    skip if power_i > 0
    alpha_i = min(0.99, op_i * exp(power_i));  skip if alpha_i < 1/255
    stop before including i if T * (1 - alpha_i) < 1e-4
    out_c += payload_c,i * alpha_i * T;  T *= (1 - alpha_i)
Pixel coordinates are integers (no +0.5 offset).

Payload row layout (PAYLOAD_ROWS = 17):
    0 mx, 1 my, 2 conic_a, 3 conic_b, 4 conic_c, 5 opacity,
    6..8 rgb, 9 depth, 10..13 quat(wxyz), 14..16 scale
Output channel layout (OUT_CHANNELS = 12):
    0..10 = accumulated payload rows 6..16, 11 = final transmittance T.
Background is not composited here.

`blend_loop_np` is a numpy copy (loops, trusted by inspection);
`blend_dense` is the torch twin of the dense O(K * H * W) pass (tests only).
"""

from __future__ import annotations

import numpy as np
import torch

from .binning import TileGrid, shift_right_logical

PAYLOAD_ROWS = 17
OUT_CHANNELS = 12
N_ACCUM = 11  # payload rows 6..16 are accumulated

ALPHA_CLAMP = 0.99
ALPHA_MIN = 1.0 / 255.0
T_EPS = 1e-4


def splat_terms(px, py, mx, my, a, b, c, op):
    """Spec alpha of splats at pixels (broadcasting): returns (alpha, valid,
    expp, alpha_raw) with expp = exp(min(power, 0)), alpha_raw = op * expp,
    alpha = min(alpha_raw, 0.99), valid = power <= 0 and alpha_raw >= 1/255.
    Evaluated in the spec's operation order, which the CUDA kernels
    (csrc/splat.cuh) follow op for op."""
    dx = px - mx
    dy = py - my
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    expp = torch.exp(torch.clamp(power, max=0.0))
    alpha_raw = op * expp
    valid = (power <= 0) & (alpha_raw >= ALPHA_MIN)
    return torch.clamp(alpha_raw, max=ALPHA_CLAMP), valid, expp, alpha_raw


def splat_alpha(px, py, mx, my, a, b, c, op):
    """(alpha, valid) of `splat_terms`: alpha where valid, else callers
    mask it to 0."""
    alpha, valid, _, _ = splat_terms(px, py, mx, my, a, b, c, op)
    return alpha, valid


def blend_loop_np(
    payload_sorted: np.ndarray,  # [17, K]
    sort_keys: np.ndarray,       # [K] packed keys (unused: ranges give membership)
    tile_starts: np.ndarray,     # [T+1]
    grid: TileGrid,
    height: int,
    width: int,
) -> np.ndarray:
    """Trusted loop implementation. Returns [12, height, width]."""
    out = np.zeros((OUT_CHANNELS, height, width), np.float64)
    pay = np.asarray(payload_sorted, np.float64)
    for ty in range(grid.nty):
        for tx in range(grid.ntx):
            t = ty * grid.ntx + tx
            s, e = int(tile_starts[t]), int(tile_starts[t + 1])
            for py in range(ty * grid.tile_h, min((ty + 1) * grid.tile_h, height)):
                for px in range(tx * grid.tile_w, min((tx + 1) * grid.tile_w, width)):
                    T = 1.0
                    acc = np.zeros(N_ACCUM)
                    for k in range(s, e):
                        mx, my, a, b, c, op = pay[:6, k]
                        dx, dy = px - mx, py - my
                        power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
                        if power > 0:
                            continue
                        alpha = min(ALPHA_CLAMP, op * np.exp(power))
                        if alpha < ALPHA_MIN:
                            continue
                        test_T = T * (1 - alpha)
                        if test_T < T_EPS:
                            break
                        acc += pay[6:, k] * alpha * T
                        T = test_T
                    out[:N_ACCUM, py, px] = acc
                    out[N_ACCUM, py, px] = T
    return out.astype(np.float32)


def blend_dense(
    payload_sorted: torch.Tensor,  # [17, K]
    sort_keys: torch.Tensor,       # [K] packed keys (SENTINEL for padding)
    tile_starts: torch.Tensor,     # unused (membership from keys); API parity
    grid: TileGrid,
    height: int,
    width: int,
) -> torch.Tensor:
    """Dense vectorized spec implementation. Returns [12, height, width].

    Differentiable w.r.t. payload_sorted. O(K * H * W): tests only."""
    dev, dt = payload_sorted.device, payload_sorted.dtype
    inst_tile = shift_right_logical(sort_keys, grid.tile_shift)  # [K]

    ys, xs = torch.meshgrid(torch.arange(height, device=dev),
                            torch.arange(width, device=dev), indexing="ij")
    pix_tile = (ys // grid.tile_h) * grid.ntx + (xs // grid.tile_w)
    px = xs.reshape(-1).to(dt)
    py = ys.reshape(-1).to(dt)
    ptile = pix_tile.reshape(-1)

    rows = [payload_sorted[i][:, None] for i in range(6)]
    alpha, valid = splat_alpha(px[None, :], py[None, :], *rows)  # [K, P]
    valid = valid & (inst_tile[:, None] == ptile[None, :])
    zero = torch.zeros((), dtype=dt, device=dev)
    alpha = torch.where(valid, alpha, zero)

    # First pass: transmittance trajectory to locate the stopping instance.
    L = torch.log1p(-alpha)
    logT = torch.cumsum(L, dim=0) - L  # exclusive
    T = torch.exp(logT)
    crossing = (T * (1.0 - alpha) < T_EPS) & (alpha > 0)
    cf = crossing.to(dt)
    crossed_before = (torch.cumsum(cf, dim=0) - cf) > 0
    include = valid & ~crossed_before & ~crossing

    # Second pass with the final inclusion set (exact T trajectory).
    alpha_inc = torch.where(include, alpha, zero)
    Li = torch.log1p(-alpha_inc)
    Ti = torch.exp(torch.cumsum(Li, dim=0) - Li)
    w = alpha_inc * Ti  # [K, P]

    acc = payload_sorted[6:] @ w  # [11, P]
    t_fin = torch.exp(torch.sum(Li, dim=0))
    out = torch.cat([acc, t_fin[None, :]], dim=0)
    return out.reshape(OUT_CHANNELS, height, width)
