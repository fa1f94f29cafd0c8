"""A test-only zoo module for the port's serving tests: the small exact
models the JAX package's serving tests export as lambdas
(``lambda p, x: x @ p["w"]`` and its kin), as a port zoo entry that
``load_model_spec("tests.torch_serving_zoo", "kind=...")`` rebuilds.

Weights keep the JAX layout (``w`` is ``[in, out]``, applied as
``x @ w``), so ``params_to_jax`` and ``params_from_jax`` are the
identity.  With small integer (or dyadic) weights and inputs every
product and sum is exact in float32, so an answer does not depend on
the batch it was computed in.

Kinds (``kind=...;bias=b;n_in=4;n_out=2``):
  linear   x @ w + bias
  scale    x * s                      (s a scalar)
  aux      x["v"] @ w * x["temp"]     (temp a per-request scalar)
  auxout   {"y": x @ w, "aux": c}     (c a fixed [4, 2] output)
  two      x["a"] @ w + x["b"]
"""

import numpy as np
import torch

from elasticdl_tpu_torch.models.spec import ModelSpec
from elasticdl_tpu_torch.serving import export as texport

MODULE = "tests.torch_serving_zoo"


class Exact(torch.nn.Module):
    def __init__(self, kind, bias, n_in, n_out):
        super().__init__()
        self.kind, self.bias = kind, float(bias)
        if kind == "scale":
            self.s = torch.nn.Parameter(torch.zeros(()))
        else:
            self.w = torch.nn.Parameter(torch.zeros(n_in, n_out))
        if kind == "auxout":
            self.c = torch.nn.Parameter(torch.zeros(4, 2))

    def forward(self, x):
        if self.kind == "linear":
            return x @ self.w + self.bias
        if self.kind == "scale":
            return x * self.s
        if self.kind == "aux":
            return x["v"] @ self.w * x["temp"]
        if self.kind == "auxout":
            return {"y": x @ self.w, "aux": self.c}
        if self.kind == "two":
            return x["a"] @ self.w + x["b"]
        raise ValueError("unknown kind %r" % self.kind)


def model_spec(kind="linear", bias=0.0, n_in=4, n_out=2, **_unused):
    def init_fn(device="cuda", seed=0):
        return Exact(kind, bias, int(n_in), int(n_out)).to(device)

    return ModelSpec(
        name="exact_" + kind, init_fn=init_fn,
        apply_fn=lambda module, x, train: module(x), feed=None,
        params_from_jax=lambda named: {
            k: v if isinstance(v, torch.Tensor)
            else torch.from_numpy(np.array(v, np.float32))
            for k, v in named.items()},
        params_to_jax=lambda module: {
            k: v.detach().cpu().numpy().copy()
            for k, v in module.state_dict().items()})


def _model_params(kind, bias, n_in, n_out):
    return "kind=%s;bias=%r;n_in=%d;n_out=%d" % (kind, float(bias), n_in,
                                                 n_out)


def serving_function(kind="linear", bias=0.0, n_in=4, n_out=2):
    """The ``kind`` model as a ``serving.export.ServingFunction`` (what
    a ``ContinuousExporter`` traces)."""
    spec = model_spec(kind, bias, n_in, n_out)
    return texport.ServingFunction(
        spec, spec.init_fn("cpu"),
        zoo=(MODULE, _model_params(kind, bias, n_in, n_out)))


def export(path, params, example, kind="linear", bias=0.0, **kwargs):
    """``export_servable`` of the ``kind`` model holding ``params``
    (``{name: ndarray}``); ``kwargs`` go to the exporter (model_name,
    version, embeddings, polymorphic_batch)."""
    n_in, n_out = np.shape(params.get("w", np.zeros((4, 2))))
    model_params = _model_params(kind, bias, n_in, n_out)
    module = model_spec(kind, bias, n_in, n_out).init_fn("cpu")
    module.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                            for k, v in params.items()})
    return texport.export_servable(str(path), MODULE, model_params,
                                   module, example, **kwargs)
