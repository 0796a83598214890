"""What the benchmark's own tests put in the program's place: the control
(the plain reference in the nearest precision below the configuration's:
float32 with TF32 matmuls, where the configuration states float32 with
TF32 off) and the program with a fault planted in its timed path."""

from __future__ import annotations

import dataclasses

import torch

from harness import sides


def control(config: dict, traffic: dict, device):
    """The reference in float32 with TF32 on, in the program's place."""
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    return sides.Reference(config, traffic, device, dtype=torch.float32)


class Faulty(sides.Program):
    """The program with one fault in its tick (``FAULT``)."""

    FAULT = None

    def tick(self, carry, x, u, obs_pos, obs_radius, timer=None):
        if self.FAULT == "half_batch":
            return self._half(carry, x, u, obs_pos, obs_radius, timer)
        new, out = super().tick(carry, x, u, obs_pos, obs_radius, timer)
        if self.FAULT == "unchanged":
            # the state returned as it came: the carry and the last answer
            n = self.system.horizon
            xs = carry.z_guess[:, :self.system.nx * (n + 1)].reshape(
                -1, n + 1, self.system.nx)
            us = carry.z_guess[:, self.system.nx * (n + 1):].reshape(
                -1, n, self.system.nu)
            return carry, dataclasses.replace(out, u0=u, x0_updated=x,
                                              horizon_x=xs, horizon_u=us)
        if self.FAULT == "altered":
            # one lane's answer nudged where it is produced
            u0 = out.u0.clone()
            u0[0, 0] += 5e-2
            hu = out.horizon_u.clone()
            hu[0, 0] = u0[0]
            return new, dataclasses.replace(out, u0=u0, horizon_u=hu)
        return new, out

    def _half(self, carry, x, u, obs_pos, obs_radius, timer):
        """Half of the batch left out: the tick runs on the first half,
        the rest get the mean over it."""
        b = x.shape[0]
        h = b // 2

        def fill(t):
            if t.dtype.is_floating_point:
                rest = t[:h].mean(0, keepdim=True)
            else:
                rest = t[:1]
            return torch.cat([t[:h], rest.expand(b - h, *t.shape[1:])])

        half = dataclasses.replace(carry, **{
            f.name: getattr(carry, f.name)[:h]
            for f in dataclasses.fields(carry)})
        new, out = super().tick(half, x[:h], u[:h], obs_pos[:h],
                                obs_radius[:h], timer)
        return (dataclasses.replace(new, **{
                    f.name: fill(getattr(new, f.name))
                    for f in dataclasses.fields(new)}),
                dataclasses.replace(out, **{
                    f.name: fill(getattr(out, f.name))
                    for f in dataclasses.fields(out)}))


def faulty(fault: str):
    return type(f"Faulty_{fault}", (Faulty,), {"FAULT": fault})


FAULTS = ("unchanged", "half_batch", "altered")
