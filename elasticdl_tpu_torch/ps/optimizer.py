"""PS-side optimizers backed by the native kernels.

Parity with the Go optimizer layer (go/pkg/ps/optimizer.go:27-390): each
optimizer exposes dense and sparse (embedding-table) application, keeps its
slot state (velocity / m / v / accumulator) as shadow buffers, and is
constructed from ``opt_type`` + "k=v;k=v" ``opt_args`` strings.
"""

import numpy as np

from elasticdl_tpu_torch.native import bindings as nk
from elasticdl_tpu_torch.ps.parameters import slot_table_name
from elasticdl_tpu_torch.utils.args import parse_opt_args


class Optimizer:
    slot_names = ()

    def __init__(self, learning_rate=0.1):
        self.learning_rate = float(learning_rate)
        self._dense_slots = {}   # (param_name, slot) -> np array
        self.step = 0

    def _slot(self, name, slot, shape):
        key = (name, slot)
        if key not in self._dense_slots:
            self._dense_slots[key] = np.zeros(shape, np.float32)
        return self._dense_slots[key]

    def apply_dense(self, name, param, grad, lr):
        raise NotImplementedError

    def apply_sparse(self, params, table_name, ids, grads, lr):
        raise NotImplementedError

    def apply_gradients(self, params, dense_grads, embedding_grads,
                        lr_multiplier=1.0):
        """dense_grads: {name: array}; embedding_grads:
        {table: (values, ids)} with ids already deduplicated."""
        self.step += 1
        lr = self.learning_rate * lr_multiplier
        for name, grad in dense_grads.items():
            param = params.dense.get(name)
            if param is None:
                raise KeyError("unknown dense parameter %r" % name)
            if param.shape != np.shape(grad):
                raise ValueError(
                    "gradient shape %s != param shape %s for %r"
                    % (np.shape(grad), param.shape, name)
                )
            self.apply_dense(
                name, param, np.ascontiguousarray(grad, np.float32), lr
            )
        for table_name, (values, ids) in embedding_grads.items():
            # The native kernels read raw float32 rows; a reduced-
            # precision wire decode or a non-contiguous merge result
            # must never reach them as-is.
            self.apply_sparse(
                params, table_name, ids,
                np.ascontiguousarray(values, np.float32), lr,
            )

    def _slot_table(self, params, table_name, slot):
        return params.slot_tables[slot_table_name(table_name, slot)]

    # -- checkpoint ---------------------------------------------------------

    def slots_to_payload(self):
        """Dense slot state + step counter for checkpoints.

        The reference Go PS persists slot state as shadow models inside the
        checkpoint (go/pkg/ps/optimizer.go:43-73 slot models +
        checkpoint.go:136-141); without this an Adam restore silently
        resets m/v to zero and bias correction to step 1.
        """
        payload = {"__step__": np.array([self.step], np.int64)}
        for (name, slot), arr in self._dense_slots.items():
            payload["%s@%s" % (name, slot)] = arr.copy()
        return payload

    def restore_slots_from_payload(self, payload):
        for key, arr in payload.items():
            if key == "__step__":
                self.step = int(np.asarray(arr).reshape(-1)[0])
            else:
                name, slot = key.rsplit("@", 1)
                self._dense_slots[(name, slot)] = np.array(
                    arr, np.float32, copy=True
                )


class SGD(Optimizer):
    def apply_dense(self, name, param, grad, lr):
        nk.sgd(param, grad, lr)

    def apply_sparse(self, params, table_name, ids, grads, lr):
        params.embeddings[table_name].apply_sgd(ids, grads, lr)


class Momentum(Optimizer):
    slot_names = ("momentum",)

    def __init__(self, learning_rate=0.1, momentum=0.9, nesterov=False):
        super().__init__(learning_rate)
        self.momentum = float(momentum)
        self.nesterov = bool(nesterov)

    def apply_dense(self, name, param, grad, lr):
        vel = self._slot(name, "momentum", param.shape)
        nk.momentum(param, grad, vel, lr, self.momentum, self.nesterov)

    def apply_sparse(self, params, table_name, ids, grads, lr):
        params.embeddings[table_name].apply_momentum(
            ids, grads, self._slot_table(params, table_name, "momentum"),
            lr, self.momentum, self.nesterov,
        )


class Adam(Optimizer):
    slot_names = ("m", "v")

    def __init__(self, learning_rate=0.001, beta_1=0.9, beta_2=0.999,
                 epsilon=1e-8, amsgrad=False):
        super().__init__(learning_rate)
        self.beta_1 = float(beta_1)
        self.beta_2 = float(beta_2)
        self.epsilon = float(epsilon)
        self.amsgrad = bool(amsgrad)
        if self.amsgrad:
            self.slot_names = ("m", "v", "max_square")

    def apply_dense(self, name, param, grad, lr):
        m = self._slot(name, "m", param.shape)
        v = self._slot(name, "v", param.shape)
        maxsq = (
            self._slot(name, "max_square", param.shape)
            if self.amsgrad else None
        )
        nk.adam(param, grad, m, v, lr, self.step, self.beta_1,
                self.beta_2, self.epsilon, max_square=maxsq)

    def apply_sparse(self, params, table_name, ids, grads, lr):
        params.embeddings[table_name].apply_adam(
            ids, grads,
            self._slot_table(params, table_name, "m"),
            self._slot_table(params, table_name, "v"),
            lr, self.step, self.beta_1, self.beta_2, self.epsilon,
            maxsq_table=(
                self._slot_table(params, table_name, "max_square")
                if self.amsgrad else None
            ),
        )


class Adagrad(Optimizer):
    slot_names = ("accumulator",)

    def __init__(self, learning_rate=0.01, epsilon=1e-8):
        super().__init__(learning_rate)
        self.epsilon = float(epsilon)

    def apply_dense(self, name, param, grad, lr):
        accum = self._slot(name, "accumulator", param.shape)
        nk.adagrad(param, grad, accum, lr, self.epsilon)

    def apply_sparse(self, params, table_name, ids, grads, lr):
        params.embeddings[table_name].apply_adagrad(
            ids, grads,
            self._slot_table(params, table_name, "accumulator"),
            lr, self.epsilon,
        )


_OPTIMIZERS = {
    "sgd": SGD,
    "momentum": Momentum,
    "adam": Adam,
    "adagrad": Adagrad,
}


def create_optimizer(opt_type, opt_args=""):
    """Build from flag strings (reference go optimizer.go:329-390)."""
    if opt_type not in _OPTIMIZERS:
        raise ValueError(
            "unknown optimizer %r (have %s)"
            % (opt_type, sorted(_OPTIMIZERS))
        )
    kwargs = parse_opt_args(opt_args) if opt_args else {}
    if "nesterov" in kwargs:
        kwargs["nesterov"] = str(kwargs["nesterov"]).lower() in (
            "true", "1", "1.0",
        )
    if "amsgrad" in kwargs:
        kwargs["amsgrad"] = str(kwargs["amsgrad"]).lower() in (
            "true", "1", "1.0",
        )
    return _OPTIMIZERS[opt_type](**kwargs)
