"""ctypes bindings for the native PS core (kernels.cc).

Auto-builds the shared library on first import (g++ is in the image;
pybind11 is not, hence a plain C ABI + ctypes).
"""

import ctypes

import numpy as np

from elasticdl_tpu_torch.native.build import build

_lib = ctypes.CDLL(build())

_i64 = ctypes.c_int64
_f32 = ctypes.c_float
_p = ctypes.c_void_p
_fp = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_ip = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")

_lib.edl_sgd.argtypes = [_fp, _fp, _i64, _f32]
_lib.edl_momentum.argtypes = [_fp, _fp, _fp, _i64, _f32, _f32,
                              ctypes.c_int]
_lib.edl_adam.argtypes = [_fp, _fp, _fp, _fp, _i64, _f32, _f32, _f32,
                          _f32, _i64, ctypes.c_void_p]
_lib.edl_adagrad.argtypes = [_fp, _fp, _fp, _i64, _f32, _f32]

_lib.edl_table_create.argtypes = [_i64, ctypes.c_int, _f32, _f32,
                                  ctypes.c_uint64]
_lib.edl_table_create.restype = _p
_lib.edl_table_destroy.argtypes = [_p]
_lib.edl_table_dim.argtypes = [_p]
_lib.edl_table_dim.restype = _i64
_lib.edl_table_size.argtypes = [_p]
_lib.edl_table_size.restype = _i64
_lib.edl_table_get.argtypes = [_p, _ip, _i64, _fp]
_lib.edl_table_get_ro.argtypes = [_p, _ip, _i64, _fp, _f32]
_lib.edl_table_get_ro.restype = _i64
_lib.edl_table_set.argtypes = [_p, _ip, _i64, _fp]
_lib.edl_table_export.argtypes = [_p, ctypes.c_void_p, ctypes.c_void_p,
                                  _i64]
_lib.edl_table_export.restype = _i64
_lib.edl_table_sgd.argtypes = [_p, _ip, _i64, _fp, _f32]
_lib.edl_table_momentum.argtypes = [_p, _p, _ip, _i64, _fp, _f32, _f32,
                                    ctypes.c_int]
_lib.edl_table_adam.argtypes = [_p, _p, _p, _p, _ip, _i64, _fp, _f32,
                                _f32, _f32, _f32, _i64]
_lib.edl_table_adagrad.argtypes = [_p, _p, _ip, _i64, _fp, _f32, _f32]

INIT_KINDS = {"zeros": 0, "uniform": 1, "normal": 2, "constant": 3}


# -- dense kernels ------------------------------------------------------------


def sgd(param, grad, lr):
    _lib.edl_sgd(param, grad, param.size, lr)


def momentum(param, grad, vel, lr, mu, nesterov=False):
    _lib.edl_momentum(param, grad, vel, param.size, lr, mu,
                      int(nesterov))


def adam(param, grad, m, v, lr, step, beta1=0.9, beta2=0.999, eps=1e-8,
         max_square=None):
    ms = (
        max_square.ctypes.data_as(ctypes.c_void_p)
        if max_square is not None else None
    )
    _lib.edl_adam(param, grad, m, v, param.size, lr, beta1, beta2, eps,
                  step, ms)


def adagrad(param, grad, accum, lr, eps=1e-8):
    _lib.edl_adagrad(param, grad, accum, param.size, lr, eps)


# -- embedding table ----------------------------------------------------------


class NativeEmbeddingTable:
    """C++ id->row store with lazy init and rw-locked concurrent access."""

    def __init__(self, dim, initializer="uniform", init_a=-0.05,
                 init_b=0.05, seed=0):
        if initializer not in INIT_KINDS:
            raise ValueError("unknown initializer %r" % initializer)
        self.dim = int(dim)
        self.initializer = initializer
        self._h = _lib.edl_table_create(
            self.dim, INIT_KINDS[initializer], init_a, init_b, seed
        )

    # keep a ref so __del__ works during interpreter shutdown
    _destroy = _lib.edl_table_destroy

    def __del__(self):
        if getattr(self, "_h", None):
            type(self)._destroy(self._h)
            self._h = None

    def __len__(self):
        return int(_lib.edl_table_size(self._h))

    def get(self, ids):
        ids = np.ascontiguousarray(ids, dtype=np.int64)
        out = np.empty((ids.size, self.dim), np.float32)
        _lib.edl_table_get(self._h, ids, ids.size, out)
        return out

    def get_ro(self, ids, default=0.0):
        """Read-only batch get (the serving lookup path): absent ids
        get ``default`` rows and are NOT lazily initialized — a
        serving-time lookup must never grow the training table.  Runs
        under the shared lock only, so lookups never serialize behind
        each other.  Returns (rows, found_count)."""
        ids = np.ascontiguousarray(ids, dtype=np.int64)
        out = np.empty((ids.size, self.dim), np.float32)
        found = _lib.edl_table_get_ro(self._h, ids, ids.size, out,
                                      float(default))
        return out, int(found)

    def set(self, ids, values):
        ids = np.ascontiguousarray(ids, dtype=np.int64)
        values = np.ascontiguousarray(values, dtype=np.float32)
        _lib.edl_table_set(self._h, ids, ids.size, values)

    def export(self):
        n = int(_lib.edl_table_export(self._h, None, None, 0))
        ids = np.empty(n, np.int64)
        values = np.empty((n, self.dim), np.float32)
        got = _lib.edl_table_export(
            self._h,
            ids.ctypes.data_as(ctypes.c_void_p),
            values.ctypes.data_as(ctypes.c_void_p),
            n,
        )
        return ids[:got], values[:got]

    # sparse optimizer application (slot tables are NativeEmbeddingTables
    # with zeros init sharing this table's id space)
    def apply_sgd(self, ids, grads, lr):
        ids = np.ascontiguousarray(ids, dtype=np.int64)
        grads = np.ascontiguousarray(grads, dtype=np.float32)
        _lib.edl_table_sgd(self._h, ids, ids.size, grads, lr)

    def apply_momentum(self, ids, grads, vel_table, lr, mu,
                       nesterov=False):
        ids = np.ascontiguousarray(ids, dtype=np.int64)
        grads = np.ascontiguousarray(grads, dtype=np.float32)
        _lib.edl_table_momentum(self._h, vel_table._h, ids, ids.size,
                                grads, lr, mu, int(nesterov))

    def apply_adam(self, ids, grads, m_table, v_table, lr, step,
                   beta1=0.9, beta2=0.999, eps=1e-8, maxsq_table=None):
        ids = np.ascontiguousarray(ids, dtype=np.int64)
        grads = np.ascontiguousarray(grads, dtype=np.float32)
        _lib.edl_table_adam(
            self._h, m_table._h, v_table._h,
            maxsq_table._h if maxsq_table is not None else None,
            ids, ids.size, grads, lr, beta1, beta2, eps, step,
        )

    def apply_adagrad(self, ids, grads, accum_table, lr, eps=1e-8):
        ids = np.ascontiguousarray(ids, dtype=np.int64)
        grads = np.ascontiguousarray(grads, dtype=np.float32)
        _lib.edl_table_adagrad(self._h, accum_table._h, ids, ids.size,
                               grads, lr, eps)
