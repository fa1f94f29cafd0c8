"""A test-only zoo entry: the MLP of ``models/mlp.py`` (``w%d``/``b%d``,
the dense stack the tabular zoo models import) as a module, so a
servable of it can be exported and held against the JAX package's
``mlp_apply``.  ``load_model_spec("tests.torch_export_zoo",
"sizes=6-16-8-3")``; the kernels map to and from the JAX layouts
through the spec's default maps."""

import torch

from elasticdl_tpu_torch.models.mlp import mlp_apply, mlp_init
from elasticdl_tpu_torch.models.spec import (ModelSpec, params_from_jax,
                                             params_to_jax)


class MLP(torch.nn.Module):
    def __init__(self, params):
        super().__init__()
        for name, value in sorted(params.items()):
            self.register_parameter(name, torch.nn.Parameter(value))

    def forward(self, x):
        return mlp_apply(dict(self.named_parameters()), x)


def model_spec(sizes="6-16-8-3"):
    sizes = [int(s) for s in str(sizes).split("-")]

    def init_fn(device="cpu", seed=0):
        gen = torch.Generator().manual_seed(int(seed))
        return MLP(mlp_init(sizes, gen)).to(device)

    return ModelSpec(
        name="mlp", init_fn=init_fn,
        apply_fn=lambda module, x, train: module(x), feed=None,
        params_from_jax=params_from_jax, params_to_jax=params_to_jax)
