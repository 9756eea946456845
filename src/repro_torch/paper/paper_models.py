"""The paper's §5 experiment models with rounded arithmetic (counterpart of
the reference's ``benchmarks/paper_models.py``).

* the quadratics of §5.1 (Settings I and II) and the Fig.-2 stagnation
  example, through ``core.gd.run_gd`` on either engine ("kernel": the
  fused update K2');
* multinomial logistic regression (§5.2): gradients from rounded
  ``qarith.qmatmul`` products, the update through the 3-step rounded
  ``gd_step`` once per epoch;
* the two-layer NN (§5.3): 784 → 100 ReLU → 1 sigmoid, binary
  cross-entropy, Xavier init.

MNIST is replaced by ``data.synthetic_mnist`` (as in the reference).
Tensors live on the device of the data handed in.  Divisions by the sample
count divide by a tensor: PyTorch's CUDA division by a Python number is a
reciprocal multiply, which would round differently from the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core import gd, prng, qarith, rounding
from repro_torch.core.rounding import RoundingSpec
from repro_torch.device import resolve_device


def _t(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32)).to(
        resolve_device(device))


def _count(X: torch.Tensor) -> torch.Tensor:
    return torch.tensor(float(X.shape[0]), dtype=torch.float32,
                        device=X.device)


def error_rate(pred: torch.Tensor, labels: torch.Tensor) -> float:
    """The share of wrong predictions as ``jnp.mean`` computes it: the
    float32 count times float32(1 / n)."""
    wrong = (pred != labels).float().sum()
    return float(wrong * float(np.float32(1.0 / labels.numel())))


def softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax(x, axis=-1)``'s formula: exp(x - max) over its sum
    (``exp`` may differ from XLA's by a float32 ulp)."""
    u = torch.exp(x - x.amax(-1, keepdim=True))
    return u / u.sum(-1, keepdim=True)


# ------------------------------------------------------------- quadratics --
def setting1(device=None):
    """§5.1 Setting I: A = diag(1e-3,…,1e-3, 1), x0 near x* except last."""
    n = 1000
    diag = np.full(n, 1e-3, np.float32)
    diag[-1] = 1.0
    x0 = np.full(n, 1e-3, np.float32)
    x0[-1] = 1.0
    xstar = np.zeros(n, np.float32)
    return _t(diag, device), _t(x0, device), _t(xstar, device), 1e-5, 1.0


def setting2(seed: int = 0, device=None):
    """§5.1 Setting II: dense symmetric A, eigenvalues 1..1000 (numpy, as
    the reference builds it)."""
    n = 1000
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    eig = np.arange(1, n + 1, dtype=np.float32)
    A = (q * eig) @ q.T
    A = ((A + A.T) / 2).astype(np.float32)
    x0 = np.arange(1000, 0, -1, dtype=np.float32)
    xstar = np.full(n, 2.0 ** -4, np.float32)
    return _t(A, device), _t(x0, device), _t(xstar, device), 1e-3, 1000.0


def run_quadratic_diag(diag, x0, xstar, t, cfg: gd.GDRounding, steps: int,
                       seed: int = 0, param_fmt=None,
                       engine: str = "jnp") -> np.ndarray:
    """f after each of ``steps`` rounded-GD steps on ½ Σ a (x − x*)²."""
    fs, _ = gd.run_gd(lambda x: 0.5 * torch.sum(diag * (x - xstar) ** 2),
                      lambda x: diag * (x - xstar), x0, t, cfg, steps,
                      key=prng.PRNGKey(seed), param_fmt=param_fmt,
                      engine=engine)
    return fs.cpu().numpy()


def run_quadratic_full(A, x0, xstar, t, cfg: gd.GDRounding, steps: int,
                       seed: int = 0, param_fmt=None,
                       engine: str = "jnp") -> np.ndarray:
    """f after each step on ½ (x − x*)ᵀ A (x − x*) (float32 products)."""
    fs, _ = gd.run_gd(
        lambda x: 0.5 * (x - xstar) @ qarith.matmul(A, x - xstar),
        lambda x: qarith.matmul(A, x - xstar), x0, t, cfg, steps,
        key=prng.PRNGKey(seed), param_fmt=param_fmt, engine=engine)
    return fs.cpu().numpy()


# -------------------------------------------------------------------- MLR --
@dataclasses.dataclass
class MLRTrainer:
    """Full-batch multinomial logistic regression with rounded arithmetic
    (``accum``: ``qarith.qmatmul``'s fidelity level)."""

    cfg: gd.GDRounding
    t: float
    grad_spec: Optional[RoundingSpec] = None   # matmul rounding grid
    accum: str = "result"
    chunk: int = 64

    def init(self, d: int = 784, classes: int = 10, device=None):
        return torch.zeros((d, classes), dtype=torch.float32,
                           device=resolve_device(device))

    def grad(self, W, X, Y1h, key):
        """∇ = Xᵀ(softmax(XW) − Y)/N with rounded products (σ₁)."""
        if self.grad_spec is None or self.grad_spec.is_identity:
            P = softmax(qarith.matmul(X, W))
            return qarith.matmul(X.T, P - Y1h) / _count(X)
        k1, k2 = prng.split(key)
        Z = qarith.qmatmul(X, W, self.grad_spec, key=k1, accum=self.accum,
                           chunk=self.chunk)
        P = softmax(Z)
        return qarith.qmatmul(X.T, (P - Y1h) / _count(X), self.grad_spec,
                              key=k2, accum=self.accum, chunk=self.chunk)

    def epoch(self, W, X, Y1h, key):
        kg, ku = prng.split(key)
        g = self.grad(W, X, Y1h, kg)
        return gd.gd_step(W, g, self.t, self.cfg, ku).x_new

    def test_error(self, W, Xte, yte) -> float:
        return error_rate(torch.argmax(qarith.matmul(Xte, W), dim=-1), yte)

    def train(self, X, y, Xte, yte, epochs: int, seed: int = 0,
              eval_every: int = 10, param_fmt=None):
        """``epochs`` full-batch epochs from W = 0; returns (W, [(epoch,
        test error)])."""
        classes = int(y.max()) + 1
        W = self.init(X.shape[1], classes, X.device)
        if param_fmt is not None:
            W = rounding.round_to_format(W, param_fmt, "rn")
        Y1h = torch.nn.functional.one_hot(y.long(), classes).float()
        key = prng.PRNGKey(seed)
        errs = []
        for e in range(epochs):
            key, sub = prng.split(key)
            W = self.epoch(W, X, Y1h, sub)
            if (e + 1) % eval_every == 0 or e == epochs - 1:
                errs.append((e + 1, self.test_error(W, Xte, yte)))
        return W, errs


# ---------------------------------------------------------- two-layer NN --
@dataclasses.dataclass
class TwoLayerNNTrainer:
    """§5.3: 784 → 100 (ReLU) → 1 (sigmoid), BCE loss, rounded GD."""

    cfg: gd.GDRounding
    t: float
    grad_spec: Optional[RoundingSpec] = None
    accum: str = "result"
    chunk: int = 64
    hidden: int = 100

    def init(self, key, d: int = 784, device=None) -> Dict[str, torch.Tensor]:
        """Xavier init of w1 (``prng.normal``, jax.random.normal's draw),
        zero biases and w2."""
        k1, _ = prng.split(key)
        scale = float(np.float32(np.sqrt(2.0 / (d + self.hidden))))
        w1 = prng.normal(k1, (d, self.hidden), resolve_device(device)) * scale

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=w1.device)
        return {"w1": w1, "b1": zeros(self.hidden), "w2": zeros(self.hidden, 1),
                "b2": zeros(1)}

    def _forward(self, params, X, key):
        if self.grad_spec is None or self.grad_spec.is_identity:
            H = torch.relu(qarith.matmul(X, params["w1"]) + params["b1"])
            return H, qarith.matmul(H, params["w2"]) + params["b2"]
        k1, k2 = prng.split(key)
        Z1 = qarith.qmatmul(X, params["w1"], self.grad_spec, key=k1,
                            accum=self.accum, chunk=self.chunk) + params["b1"]
        H = torch.relu(Z1)
        logits = qarith.qmatmul(H, params["w2"], self.grad_spec, key=k2,
                                accum=self.accum, chunk=self.chunk) \
            + params["b2"]
        return H, logits

    def grad(self, params, X, y, key):
        kf, kb1, kb2 = prng.split(key, 3)
        H, logits = self._forward(params, X, kf)
        p = torch.sigmoid(logits[:, 0])
        dlogit = ((p - y) / _count(X))[:, None]          # BCE w/ sigmoid
        spec = self.grad_spec if self.grad_spec is not None \
            else rounding.IDENTITY
        if spec.is_identity:
            gw2 = qarith.matmul(H.T, dlogit)
            dz1 = qarith.matmul(dlogit, params["w2"].T) * (H > 0)
            gw1 = qarith.matmul(X.T, dz1)
        else:
            gw2 = qarith.qmatmul(H.T, dlogit, spec, key=kb2,
                                 accum=self.accum, chunk=self.chunk)
            dz1 = qarith.matmul(dlogit, params["w2"].T) * (H > 0)
            gw1 = qarith.qmatmul(X.T, dz1, spec, key=kb1, accum=self.accum,
                                 chunk=self.chunk)
        return {"w1": gw1, "b1": dz1.sum(0), "w2": gw2,
                "b2": dlogit.sum(0)}

    def epoch(self, params, X, y, key):
        kg, ku = prng.split(key)
        g = self.grad(params, X, y, kg)
        ks = prng.split(ku, 4)
        return {name: gd.gd_step(params[name], g[name], self.t, self.cfg,
                                 ks[i]).x_new
                for i, name in enumerate(("w1", "b1", "w2", "b2"))}

    def test_error(self, params, Xte, yte) -> float:
        # evaluated in full precision on the stored (rounded) weights
        H = torch.relu(qarith.matmul(Xte, params["w1"]) + params["b1"])
        p = torch.sigmoid((qarith.matmul(H, params["w2"])
                           + params["b2"])[:, 0])
        return error_rate((p >= 0.5).float(), yte)

    def train(self, X, y, Xte, yte, epochs: int, seed: int = 0,
              eval_every: int = 5, param_fmt=None):
        params = self.init(prng.PRNGKey(seed + 1000), X.shape[1], X.device)
        if param_fmt is not None:
            params = {k: rounding.round_to_format(v, param_fmt, "rn")
                      for k, v in params.items()}
        key = prng.PRNGKey(seed)
        errs = []
        for e in range(epochs):
            key, sub = prng.split(key)
            params = self.epoch(params, X, y, sub)
            if (e + 1) % eval_every == 0 or e == epochs - 1:
                errs.append((e + 1, self.test_error(params, Xte, yte)))
        return params, errs


def to_device(data, device):
    """(X, y, Xte, yte) numpy arrays -> tensors on ``device`` (features
    float32, labels as they are: int32 classes or float32 targets)."""
    device = resolve_device(device)
    return tuple(torch.as_tensor(a).to(device) for a in data)
