"""The model-zoo contract (counterpart of
``elasticdl_tpu/models/spec.py:22-64``).

A zoo module exports ``model_spec(**kwargs)`` returning a ``ModelSpec``.
In the port:

 - ``init_fn(device)`` builds the ``nn.Module`` (a module factory, where
   the JAX package returns a params pytree);
 - ``apply_fn(module, inputs, train)`` runs it;
 - ``feed(records)`` still returns numpy ``(inputs, labels)``;
 - ``params_from_jax(named)`` maps the JAX package's flat parameter
   names and layouts (``utils.pytree.flatten_with_names``) to the
   module's ``state_dict``; ``params_to_jax(module)`` maps back.  This
   is how one npz checkpoint or servable loads into either package.

``loss_fn`` and ``optimizer`` come with the training slice.
"""

import dataclasses
import importlib
import typing

from elasticdl_tpu_torch.utils.args import parse_opt_args


@dataclasses.dataclass
class ModelSpec:
    name: str
    init_fn: typing.Callable          # device -> nn.Module
    apply_fn: typing.Callable         # (module, inputs, train) -> outputs
    feed: typing.Callable             # [records] -> (inputs, labels)
    params_from_jax: typing.Callable  # {jax name: ndarray} -> state_dict
    params_to_jax: typing.Callable    # nn.Module -> {jax name: ndarray}
    input_shape: tuple = None         # one example's shape, no batch dim


def load_model_spec(module_name, model_params="", **kwargs):
    """Import a zoo module and build its ModelSpec.

    ``module_name`` is a short zoo name ("resnet", resolved under
    ``elasticdl_tpu_torch.models``) or a full dotted path;
    ``model_params`` is a "k=v;k=v" string merged into kwargs (ints and
    floats parsed)."""
    if model_params:
        for key, value in parse_opt_args(model_params).items():
            if isinstance(value, float) and value.is_integer():
                value = int(value)
            kwargs.setdefault(key, value)
    if "." not in module_name:
        module_name = "elasticdl_tpu_torch.models." + module_name
    module = importlib.import_module(module_name)
    if not hasattr(module, "model_spec"):
        raise ValueError(
            "%s does not export model_spec(**kwargs)" % module_name
        )
    return module.model_spec(**kwargs)
