// Native parameter-server core: optimizer kernels + embedding table store.
//
// TPU-native equivalent of the reference's only native code — the Go/C++
// PS (elasticdl/go/pkg/kernel/capi/kernel_api.cc:6-96 for the kernels,
// go/pkg/common/embedding_table.go:22-88 for the table) — written fresh in
// C++17.  Dense kernels are flat SIMD-friendly loops over contiguous
// buffers (g++ -O3 -march=native auto-vectorizes them); the embedding
// store is an unordered_map of id -> row guarded by a reader/writer lock
// held for the duration of each batch operation: pulls (edl_table_get)
// run concurrently under the shared lock, while any mutation (set /
// sparse optimizer push / lazy row init) holds the unique lock for the
// whole batch.  That serializes pushes per table but makes concurrent
// pull+push / push+push on the same id well-defined — no row reference
// ever escapes the lock that protects it.
//
// Exposed as a C ABI consumed via ctypes (no pybind11 in the image).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <mutex>
#include <random>
#include <shared_mutex>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Dense optimizer kernels (in-place)
// ---------------------------------------------------------------------------

void edl_sgd(float* param, const float* grad, int64_t n, float lr) {
  for (int64_t i = 0; i < n; ++i) param[i] -= lr * grad[i];
}

void edl_momentum(float* param, const float* grad, float* vel, int64_t n,
                  float lr, float mu, int nesterov) {
  if (nesterov) {
    for (int64_t i = 0; i < n; ++i) {
      vel[i] = mu * vel[i] + grad[i];
      param[i] -= lr * (grad[i] + mu * vel[i]);
    }
  } else {
    for (int64_t i = 0; i < n; ++i) {
      vel[i] = mu * vel[i] + grad[i];
      param[i] -= lr * vel[i];
    }
  }
}

void edl_adam(float* param, const float* grad, float* m, float* v,
              int64_t n, float lr, float beta1, float beta2, float eps,
              int64_t step, float* max_square /* amsgrad slot or null */) {
  const float bc1 = 1.0f - std::pow(beta1, (float)step);
  const float bc2 = 1.0f - std::pow(beta2, (float)step);
  const float alpha = lr * std::sqrt(bc2) / bc1;
  if (max_square != nullptr) {
    for (int64_t i = 0; i < n; ++i) {
      m[i] = beta1 * m[i] + (1.0f - beta1) * grad[i];
      v[i] = beta2 * v[i] + (1.0f - beta2) * grad[i] * grad[i];
      if (v[i] > max_square[i]) max_square[i] = v[i];
      param[i] -= alpha * m[i] / (std::sqrt(max_square[i]) + eps);
    }
  } else {
    for (int64_t i = 0; i < n; ++i) {
      m[i] = beta1 * m[i] + (1.0f - beta1) * grad[i];
      v[i] = beta2 * v[i] + (1.0f - beta2) * grad[i] * grad[i];
      param[i] -= alpha * m[i] / (std::sqrt(v[i]) + eps);
    }
  }
}

void edl_adagrad(float* param, const float* grad, float* accum, int64_t n,
                 float lr, float eps) {
  for (int64_t i = 0; i < n; ++i) {
    accum[i] += grad[i] * grad[i];
    param[i] -= lr * grad[i] / (std::sqrt(accum[i]) + eps);
  }
}

}  // extern "C" (dense kernels)

// ---------------------------------------------------------------------------
// Embedding table store
// ---------------------------------------------------------------------------

namespace {

enum InitKind : int {
  kZeros = 0,
  kUniform = 1,   // U[a, b]
  kNormal = 2,    // N(a, b)
  kConstant = 3,  // a
};

struct Table {
  int64_t dim;
  int init_kind;
  float init_a;
  float init_b;
  uint64_t seed;
  std::unordered_map<int64_t, std::vector<float>> rows;
  mutable std::shared_mutex mu;

  void init_row(int64_t id, std::vector<float>& row) const {
    row.resize(dim);
    switch (init_kind) {
      case kZeros:
        std::fill(row.begin(), row.end(), 0.0f);
        break;
      case kConstant:
        std::fill(row.begin(), row.end(), init_a);
        break;
      case kUniform: {
        std::mt19937_64 rng(seed ^ (uint64_t)id * 0x9E3779B97F4A7C15ull);
        std::uniform_real_distribution<float> dist(init_a, init_b);
        for (auto& x : row) x = dist(rng);
        break;
      }
      case kNormal: {
        std::mt19937_64 rng(seed ^ (uint64_t)id * 0x9E3779B97F4A7C15ull);
        std::normal_distribution<float> dist(init_a, init_b);
        for (auto& x : row) x = dist(rng);
        break;
      }
    }
  }

  // Returns the row, creating + initializing it if absent.  Caller must
  // hold the unique lock on `mu` (the reference stays valid only while
  // that lock is held — unordered_map rehash never invalidates element
  // references, but concurrent writers would race on the row contents).
  std::vector<float>& get_or_init_unlocked(int64_t id) {
    auto [it, inserted] = rows.try_emplace(id);
    if (inserted) init_row(id, it->second);
    return it->second;
  }
};

}  // namespace

extern "C" {

void* edl_table_create(int64_t dim, int init_kind, float init_a,
                       float init_b, uint64_t seed) {
  auto* t = new Table();
  t->dim = dim;
  t->init_kind = init_kind;
  t->init_a = init_a;
  t->init_b = init_b;
  t->seed = seed;
  return t;
}

void edl_table_destroy(void* handle) { delete (Table*)handle; }

int64_t edl_table_dim(void* handle) { return ((Table*)handle)->dim; }

int64_t edl_table_size(void* handle) {
  Table* t = (Table*)handle;
  std::shared_lock<std::shared_mutex> lock(t->mu);
  return (int64_t)t->rows.size();
}

void edl_table_get(void* handle, const int64_t* ids, int64_t n,
                   float* out) {
  Table* t = (Table*)handle;
  // Fast path: copy existing rows under the shared lock so concurrent
  // pulls don't serialize; collect ids that need lazy init.
  std::vector<int64_t> missing;
  {
    std::shared_lock<std::shared_mutex> lock(t->mu);
    for (int64_t i = 0; i < n; ++i) {
      auto it = t->rows.find(ids[i]);
      if (it != t->rows.end()) {
        std::memcpy(out + i * t->dim, it->second.data(),
                    t->dim * sizeof(float));
      } else {
        missing.push_back(i);
      }
    }
  }
  if (!missing.empty()) {
    std::unique_lock<std::shared_mutex> lock(t->mu);
    for (int64_t i : missing) {
      const auto& row = t->get_or_init_unlocked(ids[i]);
      std::memcpy(out + i * t->dim, row.data(), t->dim * sizeof(float));
    }
  }
}

int64_t edl_table_get_ro(void* handle, const int64_t* ids, int64_t n,
                         float* out, float fill) {
  // Read-only batch get for the SERVING lookup path: absent ids are
  // filled with `fill` and NEVER lazily initialized — serving traffic
  // (arbitrary, possibly bogus ids from the internet) must not grow
  // the training table or perturb its id set.  Runs entirely under the
  // shared lock, so lookups never serialize behind each other.
  // Returns the number of ids found.
  Table* t = (Table*)handle;
  int64_t found = 0;
  std::shared_lock<std::shared_mutex> lock(t->mu);
  for (int64_t i = 0; i < n; ++i) {
    auto it = t->rows.find(ids[i]);
    if (it != t->rows.end()) {
      std::memcpy(out + i * t->dim, it->second.data(),
                  t->dim * sizeof(float));
      ++found;
    } else {
      std::fill(out + i * t->dim, out + (i + 1) * t->dim, fill);
    }
  }
  return found;
}

void edl_table_set(void* handle, const int64_t* ids, int64_t n,
                   const float* values) {
  Table* t = (Table*)handle;
  std::unique_lock<std::shared_mutex> lock(t->mu);
  for (int64_t i = 0; i < n; ++i) {
    auto& row = t->rows[ids[i]];
    row.assign(values + i * t->dim, values + (i + 1) * t->dim);
  }
}

int64_t edl_table_export(void* handle, int64_t* out_ids, float* out_values,
                         int64_t cap) {
  // Snapshot up to cap rows; returns row count (call with cap=0 +
  // nulls to query size first).
  Table* t = (Table*)handle;
  std::shared_lock<std::shared_mutex> lock(t->mu);
  if (cap == 0) return (int64_t)t->rows.size();
  int64_t i = 0;
  for (const auto& [id, row] : t->rows) {
    if (i >= cap) break;
    out_ids[i] = id;
    std::memcpy(out_values + i * t->dim, row.data(),
                t->dim * sizeof(float));
    ++i;
  }
  return i;
}

// -- sparse optimizer application over table rows ---------------------------
// grads: [n, dim] rows aligned with ids; slot tables hold per-id optimizer
// state and share the main table's id space (created with kZeros init).

// Each kernel holds the unique lock on the main table plus every slot
// table for the whole batch (always acquired in argument order —
// main, then slots — so concurrent pushes can't deadlock).

void edl_table_sgd(void* handle, const int64_t* ids, int64_t n,
                   const float* grads, float lr) {
  Table* t = (Table*)handle;
  std::unique_lock<std::shared_mutex> lock(t->mu);
  for (int64_t i = 0; i < n; ++i) {
    auto& row = t->get_or_init_unlocked(ids[i]);
    edl_sgd(row.data(), grads + i * t->dim, t->dim, lr);
  }
}

void edl_table_momentum(void* handle, void* vel_handle, const int64_t* ids,
                        int64_t n, const float* grads, float lr, float mu,
                        int nesterov) {
  Table* t = (Table*)handle;
  Table* vt = (Table*)vel_handle;
  std::unique_lock<std::shared_mutex> lock(t->mu);
  std::unique_lock<std::shared_mutex> vlock(vt->mu);
  for (int64_t i = 0; i < n; ++i) {
    auto& row = t->get_or_init_unlocked(ids[i]);
    auto& vel = vt->get_or_init_unlocked(ids[i]);
    edl_momentum(row.data(), grads + i * t->dim, vel.data(), t->dim, lr,
                 mu, nesterov);
  }
}

void edl_table_adam(void* handle, void* m_handle, void* v_handle,
                    void* maxsq_handle, const int64_t* ids, int64_t n,
                    const float* grads, float lr, float beta1, float beta2,
                    float eps, int64_t step) {
  Table* t = (Table*)handle;
  Table* mt = (Table*)m_handle;
  Table* vt = (Table*)v_handle;
  Table* xt = (Table*)maxsq_handle;  // may be null (no amsgrad)
  std::unique_lock<std::shared_mutex> lock(t->mu);
  std::unique_lock<std::shared_mutex> mlock(mt->mu);
  std::unique_lock<std::shared_mutex> vlock(vt->mu);
  std::unique_lock<std::shared_mutex> xlock;
  if (xt) xlock = std::unique_lock<std::shared_mutex>(xt->mu);
  for (int64_t i = 0; i < n; ++i) {
    auto& row = t->get_or_init_unlocked(ids[i]);
    auto& m = mt->get_or_init_unlocked(ids[i]);
    auto& v = vt->get_or_init_unlocked(ids[i]);
    float* maxsq = xt ? xt->get_or_init_unlocked(ids[i]).data() : nullptr;
    edl_adam(row.data(), grads + i * t->dim, m.data(), v.data(), t->dim,
             lr, beta1, beta2, eps, step, maxsq);
  }
}

void edl_table_adagrad(void* handle, void* accum_handle, const int64_t* ids,
                       int64_t n, const float* grads, float lr, float eps) {
  Table* t = (Table*)handle;
  Table* at = (Table*)accum_handle;
  std::unique_lock<std::shared_mutex> lock(t->mu);
  std::unique_lock<std::shared_mutex> alock(at->mu);
  for (int64_t i = 0; i < n; ++i) {
    auto& row = t->get_or_init_unlocked(ids[i]);
    auto& accum = at->get_or_init_unlocked(ids[i]);
    edl_adagrad(row.data(), grads + i * t->dim, accum.data(), t->dim, lr,
                eps);
  }
}

}  // extern "C"
