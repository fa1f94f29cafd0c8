"""Training callbacks (counterpart of ``elasticdl_tpu/models/callbacks.py``;
parity: elasticdl/python/elasticdl/callbacks.py:23-109).

``ModelExporter`` is the SavedModel-exporter equivalent: it runs on the
one worker that receives the train-end callback task and writes a
servable export (``serving/export.py``: the program, ``model.npz`` and
the manifest) that serving loads without the port's model zoo.  When a
checkpoint dir is given, the latest committed checkpoint (a PS job's
shards, embedding tables included) is merged in, the reference's
checkpoint-merge export path (model_handler.py:242-269).  The port reads
that checkpoint through the shards' half of ``utils/checkpoint.py``
(``latest_resumable_version``, ``load_shard``): its dense ``load``
refuses a checkpoint that holds tables.
"""

import json
import os

import numpy as np

from elasticdl_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


class ModelExporter:
    def __init__(self, export_dir, checkpoint_dir=None, model_name="",
                 versioned=False, quantize=None):
        """With ``versioned`` the export lands in
        ``export_dir/<trainer.version>/`` (the TF-Serving layout), so a
        live server pointed at ``export_dir`` hot-swaps to it; otherwise
        ``export_dir`` itself is the export (flat).
        ``quantize="int8"``: weights-only int8 servable."""
        self.export_dir = export_dir
        self.checkpoint_dir = checkpoint_dir
        self.model_name = model_name
        self.versioned = versioned
        self.quantize = quantize

    def _merged_embeddings(self):
        """({table: (ids, values)}, dense, version) from the latest
        committed checkpoint (version None when there is none)."""
        embeddings = {}
        if not self.checkpoint_dir:
            return embeddings, {}, None
        from elasticdl_tpu_torch.utils.checkpoint import CheckpointSaver

        saver = CheckpointSaver(self.checkpoint_dir)
        version = saver.latest_resumable_version(1)
        if version is None:
            logger.warning("no checkpoint to merge for export")
            return embeddings, {}, None
        # One shard of one: every dense array and every table row.
        ckpt_dense, ckpt_emb, version = saver.load_shard(version, 0, 1)
        for name, (ids, values) in ckpt_emb.items():
            if name.startswith("slot:"):
                continue  # optimizer state is not part of the model
            embeddings[name] = (ids, values)
        return embeddings, ckpt_dense, version

    def on_train_end(self, trainer):
        version = getattr(trainer, "version", 0)
        export_dir = self.export_dir
        if self.versioned:
            export_dir = os.path.join(export_dir, str(version))
        embeddings, ckpt_dense, ckpt_version = self._merged_embeddings()
        if ckpt_dense and ckpt_version is not None and (
                ckpt_version < version):
            # The trainer's in-memory train-end parameters are newer than
            # the last checkpoint (a collective trainer with a
            # checkpoint_dir): overriding name/shape-matching ones would
            # export stale weights.  Keep only names the trainer lacks.
            trainer_names = set(dict(trainer.export_parameters()))
            ckpt_dense = {n: v for n, v in ckpt_dense.items()
                          if n not in trainer_names}
        bundle = trainer.serving_bundle()
        if bundle is not None:
            from elasticdl_tpu_torch.serving.export import write_servable

            serve, params, example = bundle
            write_servable(
                export_dir, serve, params, example,
                model_name=self.model_name, version=version,
                embeddings=embeddings, dense_overrides=ckpt_dense,
                quantize=self.quantize)
            return
        # No bundle (no minibatch fixed the signature): weights only.
        if self.quantize:
            logger.warning(
                "quantize=%r ignored: the weights-only export does not "
                "quantize (no serving bundle from this trainer)",
                self.quantize)
        os.makedirs(export_dir, exist_ok=True)
        payload = dict(trainer.export_parameters())
        payload.update(ckpt_dense)
        flat_emb = {}
        for name, (ids, values) in embeddings.items():
            flat_emb["emb_ids/" + name] = ids
            flat_emb["emb_vals/" + name] = values
        with open(os.path.join(export_dir, "model.npz"), "wb") as f:
            np.savez(f, **payload, **flat_emb)
        manifest = {
            "model_name": self.model_name,
            "format": "elasticdl_tpu_export_v1",
            "parameters": sorted(payload),
            "embedding_tables": sorted(embeddings),
            "version": version,
        }
        with open(os.path.join(export_dir, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=2)
        logger.info("exported model to %s (%d tensors)", export_dir,
                    len(payload))


def load_export(export_dir):
    """An export's weights as ({name: ndarray}, {table: (ids, values)});
    int8 weights and tables dequantize, so a quantized export works
    wherever a full one does (a LoRA ``base_export`` among them).  One
    shared decode: ``serving.export.load_payload``."""
    from elasticdl_tpu_torch.serving.export import load_payload

    return load_payload(export_dir)


class LearningRateScheduler:
    """Schedule the learning rate by model version (parity:
    callbacks.py:69-109).  On the PS path the scheduled rate rides the
    push_gradients message (the trainer's ``_learning_rate``); for
    collective training prefer a schedule in the spec's optimizer."""

    def __init__(self, schedule_fn):
        self.schedule_fn = schedule_fn

    def on_train_batch_begin(self, trainer):
        lr = float(self.schedule_fn(getattr(trainer, "version", 0)))
        if hasattr(trainer, "_learning_rate"):
            trainer._learning_rate = lr
        return lr
