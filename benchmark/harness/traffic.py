"""The one traffic generator: B scenarios, each a robot on a straight lane
through its own static field of P obstacle points, every input made on the
device from the seed.

Each scenario's points lie in [lo, hi] x [lo, hi] of the robot's frame
(``field`` in the mix's file). Every step the field moves back by
``ref_speed * step_time``; a point that passes behind x = lo comes back in
at the front with a new lateral place drawn from the seed. So consecutive
scans share most of their points, as a moving robot's scans do, and every
step computes on new data. Velocities are zero, every point is valid, the
nominal trajectory is the zero-control rollout from the origin and the
reference line runs along x at ``ref_speed``, as the JAX package's
flagship benchmark builds them (bench.py).

The points of step n are a closed form of (seed, scenario, point, n): a
32-bit integer hash taken in int64 arithmetic, so the card and the CPU give
the same bits and any step of any scenario can be made again after the
window for the reference. Nothing here reads what the program returns.
"""

from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF
SUB = 65536            # sub-units of the field per step of movement


def hash32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer mix of an int64 tensor or a Python int, values in
    [0, 2**32) out; the multipliers stay below 2**31, so no product leaves
    int64."""
    x = x & M32
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & M32
    x = x ^ (x >> 15)
    x = (x * 0x6A09E667) & M32
    return x ^ (x >> 16)


def seed_key(seed: int) -> int:
    """The seed, any whole number of up to 64 bits, folded to 32."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    return hash32(hash32(s & M32) ^ (s >> 32))


class Lanes:
    """The fleet of one cell: ``batch`` scenarios of ``P`` points and horizon
    ``T``, every per-scenario tensor made on ``device``."""

    def __init__(self, seed: int, batch: int, P: int, T: int, dt: float, ref_speed: float,
                 field, device):
        self.key = seed_key(seed)
        self.batch, self.P, self.T, self.dt, self.ref_speed = batch, P, T, dt, ref_speed
        self.lo, self.hi = float(field[0]), float(field[1])
        shift = ref_speed * dt
        q = (self.hi - self.lo) * SUB / shift
        if abs(q - round(q)) > 1e-6:
            raise ValueError(f"the field's length must be a whole number of sub-units "
                             f"({shift} m / {SUB})")
        self.Q = int(round(q))
        self.device = torch.device(device)
        self._base = self._point_keys(torch.arange(batch, device=self.device))

    def _point_keys(self, ids: torch.Tensor):
        """(hb, q0), each (len(ids), P) int64: a key per point and its
        starting place along the lane in sub-units."""
        j = torch.arange(self.P, dtype=torch.int64, device=ids.device)
        hb = hash32(hash32(torch.full_like(ids, self.key) ^ ids.to(torch.int64))[:, None] ^ j[None, :])
        return hb, hash32(hb ^ 0x5BD1E995) % self.Q

    def _points(self, hb, q0, n: int) -> torch.Tensor:
        d = int(n) * SUB
        r = torch.remainder(q0 - d, self.Q)               # place along the lane
        laps = torch.div(self.Q - 1 - q0 + d, self.Q, rounding_mode="floor")
        u = hash32(hb ^ hash32(laps + 0x3C6EF372))        # lateral draw of this lap
        x = r.to(torch.float32) * ((self.hi - self.lo) / self.Q) + self.lo
        y = (u >> 8).to(torch.float32) * (2.0 ** -24) * (self.hi - self.lo) + self.lo
        return torch.stack([x, y], dim=1)

    def points(self, n: int) -> torch.Tensor:
        """The points of step n, (batch, 2, P) float32."""
        return self._points(*self._base, n)

    def points_of(self, ids, n: int, device) -> torch.Tensor:
        """The points of step n of scenarios ``ids`` (global indices), on ``device``."""
        hb, q0 = self._point_keys(torch.as_tensor(ids, dtype=torch.int64, device=device))
        return self._points(hb, q0, n)

    def fixed(self, count: int, device):
        """nom_s, nom_u, ref_s, ref_us, velocities, mask of ``count`` scenarios."""
        T, P = self.T, self.P
        f32 = torch.float32
        nom_s = torch.zeros((count, 3, T + 1), dtype=f32, device=device)
        nom_u = torch.zeros((count, 2, T), dtype=f32, device=device)
        line = torch.tensor(np.linspace([0.0, 0.0, 0.0], [self.ref_speed * self.dt * T, 0.0, 0.0],
                                        T + 1).T, dtype=f32, device=device)
        ref_s = line[None].expand(count, 3, T + 1).contiguous()
        ref_us = torch.full((count, T), float(self.ref_speed), dtype=f32, device=device)
        vel = torch.zeros((count, 2, P), dtype=f32, device=device)
        mask = torch.ones((count, P), dtype=torch.bool, device=device)
        return nom_s, nom_u, ref_s, ref_us, vel, mask


def is_sampled(key: int, n: int, every: int) -> bool:
    """Whether step n's results are checked: step 0 always, about one in
    ``every`` of the others, drawn from the seed's key."""
    return n == 0 or hash32(n ^ hash32(key ^ 0x2545F491)) % every == 0


def sampled_scenarios(seed: int, n: int, batch: int, count: int):
    """``count`` distinct scenarios of step n, drawn from the seed."""
    rng = np.random.default_rng([seed_key(seed), int(n), 0x51ED])
    return np.sort(rng.choice(batch, size=min(count, batch), replace=False))
