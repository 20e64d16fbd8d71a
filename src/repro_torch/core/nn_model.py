"""NN time/power predictor (paper §5.2, after PowerTrain [31]), in PyTorch.

Counterpart of ``repro.core.nn_model``: 4 dense layers (256/128/64/1),
ReLU and a linear head, ``x @ w + b`` with ``w`` of shape (in, out), and a
MAPE loss that penalizes under-predictions 4x (under-predicted power causes
budget violations). Inputs are standardized [cores, cpuf, gpuf, memf (, bs)]
by their mean and population std. Training is full-batch: one step of the
reference's own Adam update per epoch (not ``torch.optim.Adam``, whose eps
sits elsewhere), the parameter updates as ``torch._foreach_*`` calls.

Float32 throughout (``DTYPE``); the products run in full float32 (the
port never enables TF32). It runs on ``backend="cuda"`` (the default) or
``"cpu"``. The initial weights are drawn from a ``torch.Generator``, not
from ``jax.random``, so they differ from the reference's; a test starts
both from the same weights by replacing ``_init_params`` with the
reference's draws (``convert.nn_params``), and widens ``DTYPE`` to float64
to hold the arithmetic itself to the reference's run in float64. In
float32 the predictions are held to a tolerance, not bitwise: a gradient
entry that cancels to near Adam's eps (1e-8) takes a step anywhere
between 0 and lr depending on its rounding, and past a few hundred epochs
the loss weight flips with the sign of an error at the ulp level.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.core.backend import resolve_backend, torch_device

LAYERS = (256, 128, 64, 1)
UNDER_PENALTY = 4.0
DTYPE = np.float32          # of the data, the weights and Adam's arithmetic


def _init_params(seed: int, d_in: int) -> list:
    """He-normal weights and zero biases, one ``{"w", "b"}`` per layer,
    drawn on the CPU from a generator seeded with ``seed`` so that every
    backend starts from the same bits."""
    gen = torch.Generator().manual_seed(int(seed))
    dims = (d_in,) + LAYERS
    params = []
    for i in range(len(LAYERS)):
        w = torch.randn(dims[i], dims[i + 1], generator=gen,
                        dtype=torch.float32) * math.sqrt(2.0 / dims[i])
        params.append({"w": w, "b": torch.zeros(dims[i + 1])})
    return params


def _apply(params: list, x: torch.Tensor) -> torch.Tensor:
    for i, layer in enumerate(params):
        x = x @ layer["w"] + layer["b"]
        if i < len(params) - 1:
            x = torch.relu(x)
    return x[..., 0]


def _loss(params: list, x: torch.Tensor, y: torch.Tensor,
          scale: torch.Tensor) -> torch.Tensor:
    err = (_apply(params, x) - y) / scale
    w = torch.where(err < 0, UNDER_PENALTY, 1.0)   # under-prediction penalized
    # |err| with the reference's derivative at 0 (+1, where torch.abs has 0)
    return (w * torch.where(err >= 0, err, -err)).mean()


def _as_tensor(a, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, DTYPE)).to(dev)


@dataclasses.dataclass
class NNPredictor:
    params: list
    mean: torch.Tensor
    std: torch.Tensor

    @classmethod
    def fit(cls, features: np.ndarray, targets: np.ndarray, *,
            epochs: int = 1000, lr: float = 1e-3, seed: int = 0,
            backend: Optional[str] = None) -> "NNPredictor":
        dev = torch_device(resolve_backend(backend))
        x = _as_tensor(features, dev)
        y = _as_tensor(targets, dev)
        mean = x.mean(0)
        std = torch.clamp_min(x.std(0, correction=0), 1e-6)
        xn = (x - mean) / std
        scale = torch.clamp_min(y.abs(), 1e-6)
        params = [{k: t.to(dev, x.dtype).requires_grad_()
                   for k, t in layer.items()}
                  for layer in _init_params(seed, x.shape[1])]
        flat = [t for layer in params for t in layer.values()]
        m = [torch.zeros_like(t) for t in flat]
        v = [torch.zeros_like(t) for t in flat]
        for i in range(epochs):
            g = torch.autograd.grad(_loss(params, xn, y, scale), flat)
            t = DTYPE(i + 1)
            bc1 = float(DTYPE(1) - DTYPE(0.9) ** t)
            bc2 = float(DTYPE(1) - DTYPE(0.999) ** t)
            with torch.no_grad():
                torch._foreach_mul_(m, 0.9)
                torch._foreach_add_(m, torch._foreach_mul(g, 0.1))
                g2 = torch._foreach_mul(g, g)
                torch._foreach_mul_(g2, 0.001)
                torch._foreach_mul_(v, 0.999)
                torch._foreach_add_(v, g2)
                den = torch._foreach_div(v, bc2)
                torch._foreach_sqrt_(den)
                torch._foreach_add_(den, 1e-8)
                step = torch._foreach_div(m, bc1)
                torch._foreach_mul_(step, lr)
                torch._foreach_div_(step, den)
                torch._foreach_sub_(flat, step)
        params = [{k: t.detach() for k, t in layer.items()} for layer in params]
        return cls(params=params, mean=mean, std=std)

    def predict(self, features: np.ndarray) -> np.ndarray:
        x = (_as_tensor(features, self.mean.device) - self.mean) / self.std
        with torch.no_grad():
            return _apply(self.params, x).cpu().numpy()

    def mape(self, features: np.ndarray, targets: np.ndarray) -> float:
        pred = self.predict(features)
        return float(np.mean(np.abs(pred - targets)
                             / np.maximum(np.abs(targets), 1e-6)))


def mode_features(pm, bs: Optional[int] = None) -> list[float]:
    f = [float(pm.cores), float(pm.cpuf), float(pm.gpuf), float(pm.memf)]
    if bs is not None:
        f.append(float(bs))
    return f
