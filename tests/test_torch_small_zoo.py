"""The port's small tabular models and the two readers they train from
(elasticdl_tpu_torch/models/{heart, iris}.py, data/{sql_reader,
image_folder}.py) against the JAX package's, on the CPU.

Heart and iris get the JAX init (flax ``Dense_%d`` names) through
``spec.params_from_jax``; their forwards agree within 1e-5 absolute
(float32 matmuls of 13 and 16 terms in other orders).  The rest are the
twins of ``tests/test_heart_and_params.py``, ``tests/test_sql_iris.py``,
``tests/test_sql_reader.py`` and ``tests/test_image_folder.py`` under
their names, on the port's trainer, master and readers (the readers are
byte-identical copies: ``tests/test_torch_copies.py``).
``test_sql_iris.py::test_parse_resource_string`` has no twin here: it
tests ``client/k8s_renderer.py``, a byte-identical copy
(tests/test_torch_copies.py) that ``tests/test_torch_k8s_backend.py``
drives on the port's backend.
"""

import jax
import numpy as np
import pytest
import torch

from elasticdl_tpu.models import heart as jheart
from elasticdl_tpu.models import iris as jiris
from elasticdl_tpu.utils.pytree import flatten_with_names
from elasticdl_tpu_torch.data.factory import create_data_reader
from elasticdl_tpu_torch.data.image_folder import (
    ImageFolderDataReader,
    pack_image_folder,
    scan_image_folder,
)
from elasticdl_tpu_torch.data.sql_reader import (SQLTableDataReader,
                                                 SQLTableWriter)
from elasticdl_tpu_torch.master.task_manager import Shard, Task, TaskManager
from elasticdl_tpu_torch.models import heart, iris
from elasticdl_tpu_torch.models.spec import load_model_spec
from elasticdl_tpu_torch.worker.collective_trainer import CollectiveTrainer
from elasticdl_tpu_torch.worker.worker import Worker
from tests.test_torch_master_worker import (create_master,
                                            create_master_client)

FWD_ATOL = 1e-5


@pytest.mark.parametrize("jmod,pmod,width", [(jheart, heart, 13),
                                             (jiris, iris, 4)],
                         ids=["heart", "iris"])
def test_forward_matches_jax(jmod, pmod, width):
    jspec, pspec = jmod.model_spec(), pmod.model_spec()
    named, _ = flatten_with_names(jspec.init_fn(jax.random.PRNGKey(3)))
    params = {k: np.array(v) for k, v in named.items()}
    module = pspec.init_fn("cpu", 0)
    assert {k: v.shape for k, v in pspec.params_to_jax(module).items()} \
        == {k: v.shape for k, v in params.items()}
    module.load_state_dict(pspec.params_from_jax(params))
    x = np.random.RandomState(1).randn(32, width).astype(np.float32)
    want = np.asarray(jspec.apply_fn(jax.tree_util.tree_map(
        np.asarray, jspec.init_fn(jax.random.PRNGKey(3))), x, False))
    got = pspec.apply_fn(module, torch.from_numpy(x), False)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, atol=FWD_ATOL,
                               rtol=0)
    back = pspec.params_to_jax(module)
    for key, value in params.items():
        np.testing.assert_array_equal(back[key], value, err_msg=key)


def test_heart_learns(tmp_path):
    path = heart.synthetic_heart_csv(str(tmp_path / "heart.csv"), n=256)
    with open(path) as f:
        records = [line.strip().split(",") for line in f]
    spec = heart.model_spec(learning_rate=0.02)
    trainer = CollectiveTrainer(spec, batch_size=64, device="cpu")
    for _ in range(10):
        for i in range(0, 256, 64):
            xs, ys = spec.feed(records[i:i + 64])
            trainer.train_minibatch(xs, ys)
    correct, total = 0, 0
    for i in range(0, 256, 64):
        xs, ys = spec.feed(records[i:i + 64])
        out, labels = trainer.evaluate_minibatch(xs, ys)
        correct += ((out > 0) == labels).sum()
        total += len(labels)
    assert correct / total > 0.8


def test_model_params_string_reaches_spec():
    spec = load_model_spec(
        "transformer",
        model_params="vocab_size=128;dim=32;num_heads=2;num_layers=1;"
                     "seq_len=16",
    )
    assert spec.config.vocab_size == 128
    assert spec.config.dim == 32
    assert spec.config.num_layers == 1
    assert load_model_spec("iris", "num_classes=2;learning_rate=0.05") \
        .init_fn("cpu", 0).Dense_2.out_features == 2


def test_iris_trains_from_sql_table(tmp_path):
    db = str(tmp_path / "iris.db")
    rng = np.random.RandomState(0)
    writer = SQLTableWriter(db, "iris", ["f0", "f1", "f2", "f3", "label"])
    centers = np.array([[5.0, 3.4, 1.5, 0.2], [6.6, 3.0, 5.6, 2.1]])
    rows = []
    for _ in range(128):
        y = rng.randint(2)
        x = centers[y] + rng.randn(4) * 0.2
        rows.append(list(x) + [y])
    writer.write(rows)
    writer.close()

    reader = create_data_reader("sql:%s#iris" % db, records_per_shard=32)
    assert isinstance(reader, SQLTableDataReader)
    master = create_master(reader.create_shards(), records_per_task=32,
                           num_epochs=4)
    try:
        mc = create_master_client(master.port)
        spec = iris.model_spec(learning_rate=0.05, num_classes=2)
        trainer = CollectiveTrainer(spec, batch_size=32, device="cpu")
        Worker(mc, reader, spec, trainer, batch_size=32).run()
        assert master.task_manager.finished()
        xs, ys = spec.feed(rows)
        out, labels = trainer.evaluate_minibatch(xs[:32], ys[:32])
        assert (np.argmax(out, -1) == labels).mean() > 0.8
    finally:
        master.stop()


def test_iris_learns_from_csv(tmp_path):
    """The twin of ``tests/test_model_zoo.py::test_iris_learns_from_csv``."""
    path = iris.synthetic_iris_csv(str(tmp_path / "iris.csv"), n=120)
    with open(path) as f:
        records = [line.strip().split(",") for line in f]
    spec = iris.model_spec(learning_rate=0.05)
    trainer = CollectiveTrainer(spec, batch_size=32, device="cpu")
    for _ in range(12):
        for i in range(0, 120, 32):
            xs, ys = spec.feed(records[i:i + 32])
            trainer.train_minibatch(xs, ys)
    xs, ys = spec.feed(records)
    correct = 0
    for i in range(0, 120, 32):
        out, labels = trainer.evaluate_minibatch(xs[i:i + 32], ys[i:i + 32])
        correct += (np.argmax(out, -1) == labels).sum()
    assert correct / 120 > 0.8


def test_sql_reader_shards_and_reads(tmp_path):
    db = str(tmp_path / "data.db")
    writer = SQLTableWriter(db, "samples", ["f0", "f1", "label"])
    rows = [[float(i), float(i * 2), i % 2] for i in range(95)]
    writer.write(rows)
    writer.close()

    reader = SQLTableDataReader(db, "samples", records_per_shard=30)
    assert reader.get_size() == 95
    assert reader.columns == ["f0", "f1", "label"]
    shards = reader.create_shards()
    assert [s[2] - s[1] for s in shards] == [30, 30, 30, 5]

    tm = TaskManager(training_shards=shards, records_per_task=30)
    seen = []
    while True:
        task = tm.get(0)
        if task is None:
            break
        for record in reader.read_records(task):
            seen.append(record[0])
        tm.report(task.id, True)
    np.testing.assert_array_equal(sorted(seen), [float(i) for i in
                                                 range(95)])


# -- the twins of tests/test_image_folder.py ----------------------------


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("images")
    rng = np.random.RandomState(0)
    for cls in ("cat", "dog"):
        (root / cls).mkdir()
        for i in range(6):
            arr = (rng.rand(10, 12, 3) * 255).astype(np.uint8)
            Image.fromarray(arr).save(root / cls / ("%d.png" % i))
    return str(root)


def test_scan_sorted_and_labeled(folder):
    samples, classes = scan_image_folder(folder)
    assert classes == ["cat", "dog"]
    assert len(samples) == 12
    assert {label for _, label in samples} == {0, 1}


def test_reader_decodes_resized_float(folder):
    reader = ImageFolderDataReader(folder, image_size=8,
                                   records_per_shard=5)
    assert reader.get_size() == 12 and reader.num_classes() == 2
    shards = reader.create_shards()
    assert [s[1:] for s in shards] == [(0, 5), (5, 10), (10, 12)]
    records = list(reader.read_records(Task(0, Shard(folder, 0, 5), 0)))
    assert len(records) == 5
    x, y = records[0]
    assert x.shape == (8, 8, 3) and x.dtype == np.float32
    assert 0.0 <= x.min() and x.max() <= 1.0 and y == 0
    # shuffled indices honored
    got = [y for _, y in reader.read_records(
        Task(0, Shard(folder, 0, 12, record_indices=[11, 0]), 0))]
    assert got == [1, 0]


def test_factory_origin(folder):
    reader = create_data_reader("imagefolder:%s:16" % folder,
                                records_per_shard=4)
    x, y = next(iter(reader.read_records(Task(0, Shard(folder, 0, 1), 0))))
    assert x.shape == (16, 16, 3)


def test_pack_image_folder_roundtrip(folder, tmp_path):
    from elasticdl_tpu_torch.data.reader import RecioDataReader
    from elasticdl_tpu_torch.data.recio_gen import decode_xy

    out = str(tmp_path / "packed")
    count, classes = pack_image_folder(folder, out, image_size=8,
                                       records_per_file=5)
    assert count == 12 and classes == ["cat", "dog"]
    reader = RecioDataReader(out, decode_fn=decode_xy)
    shards = reader.create_shards()
    total = sum(end - start for _, start, end in shards)
    assert total == 12
    name, start, end = shards[0]
    x, y = next(iter(
        reader.read_records(Task(0, Shard(name, start, start + 1), 0))))
    assert x.shape == (8, 8, 3) and x.dtype == np.float32


def test_elastic_image_folder_consumes_master_indices(folder):
    """__getitem__ ignores the sampler and pulls dynamic indices (over
    the port's ``api/dataset.ElasticDataset``)."""
    from types import SimpleNamespace

    from elasticdl_tpu_torch.data.image_folder import ElasticImageFolder
    from elasticdl_tpu_torch.proto import elastic_pb2 as pb

    class FakeMC:
        def __init__(self):
            self._done = False

        def get_task(self, task_type=None):
            if self._done:
                return SimpleNamespace(id=-1, type=pb.NONE, shard=None,
                                       model_version=-1)
            self._done = True
            return SimpleNamespace(
                id=0, type=pb.TRAINING,
                shard=SimpleNamespace(name="x", start=0, end=2,
                                      record_indices=[3, 7]),
                model_version=-1,
            )

        def report_batch_done(self, count, telemetry=None):
            pass

        def report_task_result(self, *a, **k):
            pass

    ds = ElasticImageFolder(folder, FakeMC(), image_size=8)
    x0, y0 = ds[999]  # sampler index ignored
    x1, y1 = ds[0]
    assert x0.shape == (8, 8, 3)
    samples, _ = scan_image_folder(folder)
    assert (y0, y1) == (samples[3][1], samples[7][1])
    ds.stop()


def test_augmentation_preserves_shape_and_varies(folder):
    """augment: random crop + flip on the host; the origin's :augment
    option (only) enables it, and evaluation tasks read raw images."""
    from elasticdl_tpu_torch.data.image_folder import augment_image

    rng = np.random.RandomState(0)
    img = np.arange(8 * 8 * 3, dtype=np.float32).reshape(8, 8, 3)
    outs = [augment_image(img, rng) for _ in range(8)]
    assert all(o.shape == img.shape for o in outs)
    assert any(not np.array_equal(outs[0], o) for o in outs[1:])

    plain = create_data_reader("imagefolder:%s:16" % folder)
    aug = create_data_reader("imagefolder:%s:16:augment" % folder)
    task = Task(0, Shard(folder, 0, 12), 0)
    a = [r[0] for r in plain.read_records(task)]
    b = [r[0] for r in aug.read_records(task)]
    assert a[0].shape == b[0].shape == (16, 16, 3)
    assert not all(np.array_equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError, match="augment"):
        create_data_reader("imagefolder:%s:16:flip" % folder)
    with pytest.raises(ValueError, match="augment"):
        create_data_reader("imagefolder:%s:16:augment:noflip" % folder)
    eval_task = Task(0, Shard(folder, 0, 2), 1)  # EVALUATION
    raw = [r[0] for r in plain.read_records(task)]
    ev = [r[0] for r in aug.read_records(eval_task)]
    for x, y in zip(raw, ev):
        np.testing.assert_array_equal(x, y)
