"""Template bank container.

Counterpart of ``template_speech_recognition_tpu.models.bank``: K
Bernoulli templates of one registered length stacked into [K, L, F, E],
with the background [F, E] and a class label per template.  ``load``
reads the ``.npz`` that the reference's ``TemplateBank.save`` writes.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from template_speech_recognition_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class TemplateBank:
    templates: torch.Tensor         # [K, L, F, E] float32 in (0, 1)
    background: torch.Tensor        # [F, E] float32 in (0, 1)
    labels: list[str]               # len K, class name per template

    @property
    def num_templates(self) -> int:
        return int(self.templates.shape[0])

    @property
    def template_length(self) -> int:
        return int(self.templates.shape[1])

    @property
    def device(self) -> torch.device:
        return self.templates.device

    def llr(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(W [K, L, F, E], c [K]) float32 log-likelihood-ratio filter."""
        p, q = self.templates, self.background
        w = (torch.log(p) - torch.log1p(-p)) - (torch.log(q) - torch.log1p(-q))
        c = torch.sum(torch.log1p(-p) - torch.log1p(-q), dim=(1, 2, 3))
        return w, c

    def llr_rows(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(W [K, L, F, E], c_rows [K, L]) -- per-row offsets for DTW."""
        p, q = self.templates, self.background
        w = (torch.log(p) - torch.log1p(-p)) - (torch.log(q) - torch.log1p(-q))
        c_rows = torch.sum(torch.log1p(-p) - torch.log1p(-q), dim=(2, 3))
        return w, c_rows

    def llr_quantized(self, scale: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Fixed-point (W [K, L, F, E] int32, c [K] int32) for the exact
        path: ``round(x * scale)``, half to even as the reference's
        ``jnp.round``."""
        w, c = self.llr()
        return (torch.round(w * scale).to(torch.int32),
                torch.round(c * scale).to(torch.int32))

    @classmethod
    def load(cls, path: str, device=None) -> "TemplateBank":
        """Read a bank ``.npz`` (``templates``, ``background``, JSON
        ``labels``).  Parts-coded banks are not part of the port yet."""
        z = np.load(path, allow_pickle=False)
        if "parts" in z.files:
            raise NotImplementedError(
                "parts-coded banks are not ported yet (ROADMAP.md Queue 1, "
                "item 3, 'Training (config 3)')"
            )
        dev = resolve_device(device)
        return cls(
            torch.from_numpy(np.asarray(z["templates"], np.float32)).to(dev),
            torch.from_numpy(np.asarray(z["background"], np.float32)).to(dev),
            json.loads(str(z["labels"])),
        )
