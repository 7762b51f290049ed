"""Multimodal MLP projector, `mlp2x_gelu` (port of
leopard_tpu/models/projector.py): Linear → GELU (exact) → Linear, with bias.
The input is the vision width ×4 after the 2×2 pixel shuffle. Under tensor
parallelism fc1 is column-parallel and fc2 row-parallel."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from leopard_tpu_torch.config import ProjectorConfig
from leopard_tpu_torch.models.params import Params, torch_dtype
from leopard_tpu_torch.parallel.tensor_parallel import copy_to_tp, row_linear


class Projector(Params):
    par = None  # parallel/mesh.py::Parallel, set by set_parallel

    def __init__(self, cfg: ProjectorConfig, device=None):
        if cfg.projector_type != "mlp2x_gelu":
            raise NotImplementedError(f"projector {cfg.projector_type!r} is not in the port")
        h = cfg.hidden_size
        super().__init__(
            {"fc1": (h, cfg.input_size), "b1": (h,), "fc2": (h, h), "b2": (h,)},
            dtype=torch_dtype(cfg.dtype), device=device,
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.gelu(F.linear(copy_to_tp(x, self.par), self.fc1, self.b1))
        return row_linear(y, self.fc2, self.b2, self.par)
