"""Image-folder dataset plumbing (the ImageNet-layout path).

Reference counterparts: torchvision-ImageFolder-based ElasticImageFolder
(elasticai_api/pytorch/dataset.py:33-92) and the image recordio
generators (data/recordio_gen/image_label.py).  TPU-native pieces:

 - ``ImageFolderDataReader``: an AbstractDataReader over the standard
   ``root/<class_name>/<image>`` layout.  Shards are index ranges into
   the sorted (path, label) list, so dynamic sharding, retries, and
   shuffle-by-record-indices behave exactly like every other reader.
   Decode = PIL -> RGB -> resize -> float32 [H, W, 3] in [0, 1], done
   on the host; batches then feed the jitted step as one contiguous
   device_put (keep per-image work on the host, the MXU never sees
   JPEG bytes).
 - ``ElasticImageFolder``: map-style dataset whose __getitem__ consumes
   master-assigned indices (api/dataset.py ElasticDataset over the
   folder source) — drop-in for a stock torch DataLoader loop.
 - ``pack_image_folder``: offline packing of the folder into recio
   files (decode once, train many) via data/recio_gen's npz payloads.
"""

import os

import numpy as np

from elasticdl_tpu_torch.data.reader import AbstractDataReader

_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".gif", ".webp")


def scan_image_folder(root):
    """-> (samples [(path, label_id)], class_names sorted)."""
    classes = sorted(
        d for d in os.listdir(root)
        if os.path.isdir(os.path.join(root, d))
    )
    if not classes:
        raise ValueError("no class directories under %r" % root)
    samples = []
    for label, name in enumerate(classes):
        class_dir = os.path.join(root, name)
        # os.listdir, not glob: dataset paths with glob metacharacters
        # ("run[1]") must not silently drop images.
        for fname in sorted(os.listdir(class_dir)):
            if fname.lower().endswith(_EXTENSIONS):
                samples.append((os.path.join(class_dir, fname), label))
    if not samples:
        raise ValueError("no images under %r" % root)
    return samples, classes


def load_image(path, image_size):
    from PIL import Image

    with Image.open(path) as img:
        img = img.convert("RGB")
        if image_size:
            img = img.resize((image_size, image_size))
        return np.asarray(img, np.float32) / 255.0


def augment_image(img, rng, crop_padding=0.125):
    """Standard training augmentation: random resized crop (pad-style
    — the image is upscaled by ``crop_padding`` and a random
    image-size window is taken) + random horizontal flip.

    Pure numpy on the HOST, inside the data plane's prefetch threads —
    augmentation must never be traced into the jitted step (it would
    either freeze the randomness as constants or force per-step
    recompiles; the reference likewise augments in the input
    pipeline).  Output shape equals input shape, so the static-shape
    contract of the compiled step is untouched.
    """
    h, w = img.shape[:2]
    pad_h = int(round(h * crop_padding))
    pad_w = int(round(w * crop_padding))
    if pad_h and pad_w:
        padded = np.pad(
            img, ((pad_h, pad_h), (pad_w, pad_w), (0, 0)),
            mode="reflect")
        top = rng.randint(0, 2 * pad_h + 1)
        left = rng.randint(0, 2 * pad_w + 1)
        img = padded[top:top + h, left:left + w]
    if rng.rand() < 0.5:
        img = img[:, ::-1]
    return np.ascontiguousarray(img)


class ImageFolderDataReader(AbstractDataReader):
    def __init__(self, root, image_size=224, records_per_shard=1024,
                 augment=False, seed=None):
        """``seed=None`` (default) draws fresh OS entropy per process —
        N workers (and every relaunch) must NOT replay one identical
        augmentation stream; pass a seed only for reproducibility in
        tests."""
        self._root = root
        self._image_size = image_size
        self._records_per_shard = records_per_shard
        self._augment = augment
        self._rng = np.random.RandomState(seed)
        self.samples, self.class_names = scan_image_folder(root)

    @property
    def records_per_shard(self):
        return self._records_per_shard

    def num_classes(self):
        return len(self.class_names)

    def get_size(self):
        return len(self.samples)

    def create_shards(self):
        shards = []
        start = 0
        n = len(self.samples)
        while start < n:
            end = min(start + self._records_per_shard, n)
            shards.append((self._root, start, end))
            start = end
        return shards

    def _record(self, i, augment):
        path, label = self.samples[i]
        img = load_image(path, self._image_size)
        if augment:
            img = augment_image(img, self._rng)
        return img, label

    def read_records(self, task):
        from elasticdl_tpu_torch.proto import elastic_pb2 as pb

        # Augment TRAINING records only: evaluation/prediction through
        # the same reader must see the raw images (random crops would
        # make validation metrics noisy and non-reproducible).
        augment = self._augment and (
            getattr(task, "type", pb.TRAINING) == pb.TRAINING
        )
        indices = task.shard.record_indices or range(
            task.shard.start, min(task.shard.end, len(self.samples))
        )
        for i in indices:
            yield self._record(i, augment)


class ElasticImageFolder:
    """Stock-DataLoader-compatible elastic dataset over an image folder
    (reference ElasticImageFolder semantics: __getitem__ pulls the next
    master-assigned record index; __len__ is unbounded)."""

    def __init__(self, root, master_client, image_size=224,
                 batch_size=1):
        from elasticdl_tpu_torch.api.dataset import ElasticDataset

        self._reader = ImageFolderDataReader(root, image_size=image_size)
        self._elastic = ElasticDataset(
            _IndexableFolder(self._reader), master_client,
            batch_size=batch_size,
        )
        self.class_names = self._reader.class_names

    def __len__(self):
        return len(self._elastic)

    def __getitem__(self, index):
        return self._elastic[index]

    def report_batch_done(self, batch_size=None):
        self._elastic.report_batch_done(batch_size)

    def stop(self):
        self._elastic.stop()


class _IndexableFolder:
    def __init__(self, reader):
        self._reader = reader

    def __getitem__(self, i):
        # Torch-style training dataset: augment iff the reader asks.
        return self._reader._record(i, self._reader._augment)


def pack_image_folder(root, output_dir, image_size=224,
                      records_per_file=1024):
    """Decode once, train many: pack the folder into recio files of
    npz-encoded (x [H,W,3] f32, y int32) records."""
    from elasticdl_tpu_torch.data.recio import RecioWriter
    from elasticdl_tpu_torch.data.recio_gen import encode_record

    samples, classes = scan_image_folder(root)
    os.makedirs(output_dir, exist_ok=True)
    writer = None
    file_idx = count = 0
    for path, label in samples:
        if writer is None:
            writer = RecioWriter(
                os.path.join(output_dir, "images-%05d.recio" % file_idx)
            )
        writer.write(encode_record(
            x=load_image(path, image_size),
            y=np.asarray(label, np.int32),
        ))
        count += 1
        if count % records_per_file == 0:
            writer.close()
            writer = None
            file_idx += 1
    if writer is not None:
        writer.close()
    with open(os.path.join(output_dir, "classes.txt"), "w") as f:
        f.write("\n".join(classes))
    return count, classes
