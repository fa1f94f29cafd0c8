"""The model-zoo contract (counterpart of
``elasticdl_tpu/models/spec.py:22-64``).

A zoo module exports ``model_spec(**kwargs)`` returning a ``ModelSpec``.
In the port:

 - ``init_fn(device, seed)`` builds the ``nn.Module`` with weights drawn
   from the JAX package's initializer families, from an explicit
   ``torch.Generator`` (a module factory, where the JAX package returns
   a params pytree);
 - ``apply_fn(module, inputs, train)`` runs it;
 - ``loss_fn(outputs, labels)`` returns a per-example float32 loss
   vector; the trainer masks padding and reduces;
 - ``optimizer(named_parameters)`` returns a ``torch.optim.Optimizer``
   (a factory, where the JAX package holds an optax transformation); it
   is given the module's ``named_parameters()``, which torch optimizers
   take as they take parameters, so a spec may group them by name;
 - ``feed(records)`` still returns numpy ``(inputs, labels)``;
 - ``eval_metrics_fn()`` returns ``{name: utils.metrics.Metric}``;
 - ``params_from_jax(named)`` maps the JAX package's flat parameter
   names and layouts (``utils.pytree.flatten_with_names``) to the
   module's ``state_dict``; ``params_to_jax(module)`` maps back.  This
   is how one npz checkpoint or servable loads into either package;
 - ``to_jax_layout`` and ``from_jax_layout`` map one tensor of a
   parameter's shape (the parameter, or one of its optimizer slots) to
   the JAX package's layout and back; the trainer saves and restores
   optimizer state through them;
 - ``generate_fn(module, prompt, max_new_tokens, temperature, seed)``
   serves a generation export (language models only);
 - ``callbacks`` lists training callbacks for the worker's task loop
   (empty by default);
 - ``prediction_outputs_processor`` receives a predict job's outputs
   (``process(outputs, worker_id)``, then ``flush()`` at each task's
   end); the worker installs ``NpzPredictionWriter`` where a spec sets
   none.

The functions below implement those maps for modules whose submodules
carry flax's call-order names (``Conv_0``, ``Dense_1``): conv kernels
HWIO <-> OIHW, dense kernels ``[in, out]`` <-> ``[out, in]``, every
other leaf unchanged.  The two layout maps are the defaults of a
``ModelSpec``; a model that keeps the JAX layouts (the transformer)
supplies its own.
"""

import dataclasses
import importlib
import typing

import numpy as np
import torch

from elasticdl_tpu_torch.utils.args import parse_opt_args


def jax_name(torch_name):
    """``Bottleneck_3.Conv_1.weight`` -> ``Bottleneck_3/Conv_1/kernel``."""
    *path, leaf = torch_name.split(".")
    return "/".join(path + ["kernel" if leaf == "weight" else leaf])


def to_jax_layout(value):
    """A module tensor -> a host ndarray (always a copy) in the JAX
    layout: OIHW -> HWIO, ``[out, in]`` -> ``[in, out]``."""
    value = value.detach().to("cpu", copy=True).numpy()
    if value.ndim == 4:
        value = value.transpose(2, 3, 1, 0)
    elif value.ndim == 2:
        value = value.T
    return np.ascontiguousarray(value)


def from_jax_layout(value):
    """The inverse of ``to_jax_layout``: an ndarray in the JAX layout ->
    a CPU tensor in the module's layout."""
    value = np.asarray(value)
    if value.ndim == 4:
        value = value.transpose(3, 2, 0, 1)
    elif value.ndim == 2:
        value = value.T
    return torch.from_numpy(np.ascontiguousarray(value))


@dataclasses.dataclass
class ModelSpec:
    name: str
    init_fn: typing.Callable          # (device, seed) -> nn.Module
    apply_fn: typing.Callable         # (module, inputs, train) -> outputs
    feed: typing.Callable             # [records] -> (inputs, labels)
    params_from_jax: typing.Callable  # {jax name: ndarray} -> state_dict
    params_to_jax: typing.Callable    # nn.Module -> {jax name: ndarray}
    input_shape: tuple = None         # one example's shape, no batch dim
    loss_fn: typing.Callable = None   # (outputs, labels) -> [batch] f32
    optimizer: typing.Callable = None  # named parameters -> Optimizer
    eval_metrics_fn: typing.Callable = None  # () -> {name: Metric}
    # (module, prompt, max_new_tokens, temperature, seed) -> tokens;
    # set by zoo entries that serve generation exports
    generate_fn: typing.Callable = None
    # One leaf's layout in the JAX package (optimizer slots included):
    # tensor -> ndarray, ndarray -> CPU tensor.
    to_jax_layout: typing.Callable = to_jax_layout
    from_jax_layout: typing.Callable = from_jax_layout
    # Training callbacks (``on_train_batch_begin(trainer)``,
    # ``on_train_end(trainer)``) the worker calls; a non-empty list makes
    # the master schedule a train-end task.  No zoo model of the port
    # sets any yet (``models/callbacks.py`` is ROADMAP A11).
    callbacks: list = dataclasses.field(default_factory=list)
    # A predict job's output sink (worker/prediction_outputs_processor).
    prediction_outputs_processor: typing.Any = None


def params_from_jax(named):
    """``{flax name: ndarray}`` -> ``state_dict`` of the matching module
    (``Conv_0/kernel`` -> ``Conv_0.weight`` in OIHW, ...)."""
    state = {}
    for name, value in named.items():
        *path, leaf = name.split("/")
        state[".".join(path + ["weight" if leaf == "kernel" else leaf])] = (
            from_jax_layout(value))
    return state


def params_to_jax(module):
    """Module -> ``{flax name: ndarray}`` in the JAX layouts (copies)."""
    return {jax_name(name): to_jax_layout(value)
            for name, value in module.state_dict().items()}


def lecun_normal_(weight, generator):
    """flax's default kernel init, ``variance_scaling(1, "fan_in",
    "truncated_normal")``: a normal truncated at two standard deviations,
    scaled so that the variance is 1 / fan_in.  The fan-in is every axis
    of the kernel but its output axis (dim 0 of a torch weight)."""
    fan_in = weight[0].numel()
    # 0.8796... is the standard deviation of a unit normal truncated to
    # [-2, 2]; flax divides by it so the variance is 1 / fan_in.
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    with torch.no_grad():
        return torch.nn.init.trunc_normal_(weight, 0.0, std, -2 * std,
                                           2 * std, generator=generator)


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
