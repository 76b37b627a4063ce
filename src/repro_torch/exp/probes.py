"""Per-step probes: what the simulation records each step.

Counterpart of ``repro/exp/probes.py``.  ``SimResult.records`` is a dict
of ``[T, ...]`` tensors (``[B, T, ...]`` under
:func:`repro_torch.exp.run_trials`, one row per lane, as the
reference's):

=========== ======================= ====================================
key         shape per step          meaning
=========== ======================= ====================================
raster      [n] bool                full spike raster
v           [len(voltage)]          membrane potential of the sampled
                                    neurons, engine-native units (mV
                                    float path, Q19.12 fixed point)
pop_rate_hz scalar float32          population mean firing rate this step
dropped     scalar int32            synapse events lost to capacity limits
=========== ======================= ====================================
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ProbeSpec:
    """Selection of per-step records."""

    raster: bool = False
    voltage: tuple[int, ...] = ()    # neuron ids whose v is traced
    pop_rate: bool = False
    drops: bool = False

    def __post_init__(self):
        object.__setattr__(self, "voltage", tuple(int(i) for i in self.voltage))

    @property
    def any(self) -> bool:
        return bool(self.raster or self.voltage or self.pop_rate or self.drops)

    def check(self, n: int) -> None:
        """Raise on voltage probe ids outside ``[0, n)``."""
        bad = [i for i in self.voltage if not 0 <= i < n]
        if bad:
            raise ValueError(f"voltage probe ids {bad} out of range for n={n}")

    def collect(self, *, spikes: torch.Tensor, lif, drop: torch.Tensor,
                params, voltage_rows: torch.Tensor | None = None) -> dict:
        """This step's record dict, for ``spikes`` ``[..., n]`` (a trial
        batch's ``[B, n]``: every record gets the same leading axes).
        ``voltage_rows`` is ``self.voltage`` as a tensor on the state's
        device, made once per run by the caller (else here, per call)."""
        rec: dict = {}
        n = spikes.shape[-1]
        if self.raster:
            rec["raster"] = spikes
        if self.voltage:
            if voltage_rows is None:
                self.check(n)
                voltage_rows = torch.tensor(self.voltage, dtype=torch.long,
                                            device=spikes.device)
            rec["v"] = lif.v[..., voltage_rows]
        if self.pop_rate:
            # XLA compiles the reference's mean(s) / (dt * 1e-3) into one
            # multiply, sum(s) * (1/n * 1/dt_s), with both reciprocals and
            # their product rounded to float32; so does this.
            one = np.float32(1.0)
            scale = ((one / np.float32(n))
                     * (one / np.float32(params.dt * 1e-3)))
            rec["pop_rate_hz"] = (spikes.to(torch.float32).sum(dim=-1)
                                  * float(scale))
        if self.drops:
            rec["dropped"] = drop.to(torch.int32)
        return rec


NO_PROBES = ProbeSpec()

__all__ = ["NO_PROBES", "ProbeSpec"]
