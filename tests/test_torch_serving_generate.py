"""LM generation through the port's micro-batcher
(``serving/batcher.py`` behind ``ModelEndpoint``, a generation export of
``models/transformer.export_generate``), on the CPU in float32, beside
the JAX package's ``generate`` on the same weights.

Concurrent clients send 1-3 prompt rows each; the executor coalesces
them and pads each batch up to a bucket of 1, 2, 4, 8 with copies of its
first row.
Every executed batch is recorded (its padded input and output), and
each answer must be its rows of that batch, and that batch's output
what one direct ``predict`` of the same padded input returns, bit for
bit: the gate the card keeps too.  On the CPU in float32:

 - greedy: a request's tokens batched equal its tokens served alone, in
   both packages, and the JAX package's tokens for the same prompts
   (each request padded as the batcher pads to the next
   bucket past it, against it alone; in the JAX package the first
   request of each size), dense and MoE: MoE capacity is sized per
   sequence in both, so the padded rows of a bucket move no real row's
   dispatch;
 - sampled: the JAX reference's property first (a row's tokens depend on
   the seed and on its place in the batch, not on the rows padded after
   it), then the port held to the same; through the batcher, requests
   coalesce only with equal seeds, and each answer is its rows of the
   executed batch.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdl_tpu.models import transformer as jtfm
from elasticdl_tpu.utils.pytree import flatten_with_names
from elasticdl_tpu_torch.models import transformer as ttfm
from elasticdl_tpu_torch.serving import server as tserver
from elasticdl_tpu_torch.serving.batcher import BatchConfig, pick_bucket

BASE = dict(vocab_size=128, dim=64, num_heads=4, num_layers=2,
            max_seq_len=32, dtype="float32")
CASES = {"dense": {}, "moe": {"moe_experts": 4, "moe_top_k": 2}}
PROMPT, NEW = 5, 6
BUCKETS = [1, 2, 4, 8]
REQUEST_ROWS = [1, 2, 3, 2, 1]
TEMPERATURE = 0.8


def build(case, seed=7):
    """(JAX cfg, JAX params, port cfg, port module), same weights."""
    kw = dict(BASE, **CASES[case])
    jcfg, tcfg = jtfm.TransformerConfig(**kw), ttfm.TransformerConfig(**kw)
    jparams = jtfm.init_params(jax.random.PRNGKey(seed), jcfg)
    named = {k: np.asarray(v)
             for k, v in flatten_with_names(jparams)[0].items()}
    module = ttfm.TransformerLM(tcfg)
    module.load_state_dict(ttfm.params_from_jax(named))
    return jcfg, jparams, tcfg, module


def prompts(seed=3):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, BASE["vocab_size"], size=(n, PROMPT)
                        ).astype(np.int32) for n in REQUEST_ROWS]


def serve(export_dir, bodies, waves=1):
    """Each body from a thread of its own through a batching endpoint, in
    ``waves`` equal waves: the threads of a wave are released together,
    once the wave before has been answered.  Returns (answers, executed
    batches as (padded input, output), the model's own ``predict``)."""
    endpoint = tserver.ModelEndpoint(
        export_dir, device="cpu", batching=BatchConfig(
            max_batch_size=BUCKETS[-1], batch_timeout_ms=300.0,
            pad_buckets=BUCKETS, warm=False))
    model = endpoint.model
    direct, batches, lock = model.predict, [], threading.Lock()

    def recorded(inputs):
        out = direct(inputs)
        with lock:
            batches.append(({k: np.array(v) for k, v in inputs.items()}
                            if isinstance(inputs, dict)
                            else np.array(inputs), np.array(out)))
        return out

    model.predict = recorded
    answers = [None] * len(bodies)
    size = len(bodies) // waves
    go = threading.Barrier(size)

    def client(i):
        go.wait()
        answers[i] = np.asarray(endpoint.predict(bodies[i])["predictions"])

    try:
        for first in range(0, len(bodies), size):
            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(first, first + size)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
    finally:
        endpoint.close()
    assert all(a is not None for a in answers)
    return answers, batches, direct


def rows_of(batch_input):
    return (batch_input["prompt"] if isinstance(batch_input, dict)
            else batch_input)


def check_against_batches(requests, answers, batches, direct):
    """Each answer is its rows of exactly one executed batch, whose
    output a direct predict of the same padded input repeats bit for
    bit; every batch is padded to a bucket and coalesced at least once.
    Returns, per request, (its batch's input, its first row there)."""
    where = []
    for rows, answer in zip(requests, answers):
        found = {}
        for b, (inp, out) in enumerate(batches):
            prompt = rows_of(inp)
            for at in range(len(prompt) - len(rows) + 1):
                if (np.array_equal(prompt[at:at + len(rows)], rows)
                        and np.array_equal(out[at:at + len(rows)],
                                           answer)):
                    # The first match: padding repeats the first row.
                    found.setdefault(b, (inp, at))
        assert len(found) == 1, sorted(found)
        where.extend(found.values())
    for inp, out in batches:
        assert len(rows_of(inp)) in BUCKETS
        np.testing.assert_array_equal(direct(inp), out)
    assert len(batches) < len(requests)
    return where


@pytest.mark.parametrize("case", sorted(CASES))
def test_batched_greedy_equals_each_request_alone(case, tmp_path):
    jcfg, jparams, tcfg, module = build(case)
    ttfm.export_generate(str(tmp_path / "lm"), module, tcfg,
                         max_new_tokens=NEW, prompt_len=PROMPT)
    requests = prompts()
    answers, batches, direct = serve(
        str(tmp_path / "lm"), [{"instances": p.tolist()} for p in requests])
    check_against_batches(requests, answers, batches, direct)
    # One compiled program a batch size (the same tokens as the eager
    # call, which compiles prefill op by op and the decode scan anew).
    jax_generate = jax.jit(jtfm.generate, static_argnums=(1, 3))
    sizes = set()
    for rows, answer in zip(requests, answers):
        # Copies of its first row after it, up to the next bucket past it.
        pad = pick_bucket(len(rows) + 1, BUCKETS) - len(rows)
        padded = np.concatenate([rows, np.repeat(rows[:1], pad, axis=0)])
        alone = ttfm.generate(module, tcfg, rows, NEW).numpy()
        np.testing.assert_array_equal(answer, alone)
        np.testing.assert_array_equal(
            ttfm.generate(module, tcfg, padded, NEW).numpy()[:len(rows)],
            alone)
        # The served tokens are the JAX package's for the same prompts.
        jax_alone = np.asarray(jax_generate(jparams, jcfg, jnp.asarray(rows),
                                            NEW))
        np.testing.assert_array_equal(answer, jax_alone)
        if len(rows) in sizes:
            continue
        sizes.add(len(rows))
        np.testing.assert_array_equal(
            np.asarray(jax_generate(jparams, jcfg, jnp.asarray(padded),
                                    NEW))[:len(rows)], jax_alone)


def test_sampled_rows_depend_on_their_place_not_on_padding(tmp_path):
    jcfg, jparams, tcfg, module = build("dense")
    rows = prompts()[2]                                   # 3 rows
    padded = np.concatenate([rows, np.zeros((1, PROMPT), np.int32)])
    moved = rows[[1, 1, 2]]

    jax_generate = jax.jit(jtfm.generate, static_argnums=(1, 3),
                           static_argnames=("temperature",))

    def jax_gen(p):
        return np.asarray(jax_generate(
            jparams, jcfg, jnp.asarray(p), NEW, temperature=TEMPERATURE,
            rng=jax.random.PRNGKey(7)))

    def port_gen(p):
        return ttfm.generate(module, tcfg, p, NEW, temperature=TEMPERATURE,
                             seed=7).numpy()

    for gen in (jax_gen, port_gen):
        three = gen(rows)
        np.testing.assert_array_equal(gen(padded)[:3], three)
        # Row 1 at place 0 draws place 0's noise, not its own.
        again = gen(moved)
        np.testing.assert_array_equal(again[1:], three[1:])
        assert not np.array_equal(again[0], three[1])

    ttfm.export_generate(str(tmp_path / "lm"), module, tcfg,
                         max_new_tokens=NEW, prompt_len=PROMPT,
                         temperature=TEMPERATURE)
    requests = prompts() + prompts(seed=4)
    seeds = [7] * 5 + [8] * 5
    # A wave a seed: a batch only coalesces requests of equal seeds, so
    # requests of two seeds arriving interleaved would run one by one.
    answers, batches, direct = serve(
        str(tmp_path / "lm"),
        [{"inputs": {"prompt": p.tolist(), "seed": s}}
         for p, s in zip(requests, seeds)], waves=2)
    where = check_against_batches(requests, answers, batches, direct)
    for (inp, at), rows, seed, answer in zip(where, requests, seeds,
                                             answers):
        assert int(inp["seed"]) == seed
        whole = port_gen(inp["prompt"]) if seed == 7 else ttfm.generate(
            module, tcfg, inp["prompt"], NEW, temperature=TEMPERATURE,
            seed=seed).numpy()
        np.testing.assert_array_equal(whole[at:at + len(rows)], answer)
    assert torch.equal(torch.as_tensor(answers[0][:, :PROMPT]),
                       torch.as_tensor(requests[0]))


def test_sampling_noise_is_counter_based():
    """The sampling uniforms hash (seed, step, element index) with
    splitmix64 in wrapping int64 ops, bit for bit the uint64 mix done on
    the host (so every device draws the same noise); a row's uniforms do
    not depend on the batch size, and lie in (0, 1)."""
    mask = (1 << 64) - 1

    def mix(z):
        z = (z + 0x9E3779B97F4A7C15) & mask
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & mask
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & mask
        return z ^ (z >> 31)

    rng = np.random.RandomState(5)
    xs = [int(x) for x in rng.randint(np.iinfo(np.int64).min,
                                      np.iinfo(np.int64).max, size=256,
                                      dtype=np.int64)]
    xs += [0, -1, np.iinfo(np.int64).max, np.iinfo(np.int64).min]
    got = ttfm._splitmix64(torch.tensor(xs, dtype=torch.long)).tolist()
    assert [g & mask for g in got] == [mix(x & mask) for x in xs]
    vocab = BASE["vocab_size"]
    eight = ttfm._step_uniforms(torch.arange(8 * vocab).view(8, vocab), 7, 3)
    three = ttfm._step_uniforms(torch.arange(3 * vocab).view(3, vocab), 7, 3)
    assert torch.equal(eight[:3], three)
    assert not torch.equal(
        three, ttfm._step_uniforms(torch.arange(3 * vocab).view(3, vocab),
                                   7, 4))
    assert 0.0 < float(eight.min()) and float(eight.max()) < 1.0
