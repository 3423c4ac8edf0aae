"""Typed configuration for the framework (the PyTorch port's own copy).

A field-for-field copy of ``fashionvisualexpl_tpu/core/config.py``: the port
imports nothing of the JAX package, so it carries the dataclasses that
``data/interactions.py::Interactions.load`` reads.  The two must stay equal.

Replaces the reference's two untyped config channels — the module-constant path
templates (reference src/config/configs.py:1-33) and the argparse Namespace
duck-typed into every model (reference src/train_rec.py:17-46) — with frozen
dataclasses.  Models declare the fields they need, so the reference's class of
"reads a flag argparse never defines" bugs (e.g. GradFashion.py:29-30 reading
params.embed_color) cannot occur.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import List, Optional, Tuple


@dataclass(frozen=True)
class Paths:
    """Dataset/feature/result path layout.

    Mirrors the template layout of reference src/config/configs.py so datasets
    prepared for the reference are drop-in usable.  `root` replaces the
    hardcoded '../data' prefix; every accessor takes the dataset name.
    """

    root: str = "data"
    results_root: str = "results"

    # --- interaction data (configs.py:2-14) ---
    def data_dir(self, dataset: str) -> str:
        return os.path.join(self.root, dataset)

    def all_interactions(self, dataset: str) -> str:
        return os.path.join(self.data_dir(dataset), "all_interactions.tsv")

    def all_final(self, dataset: str) -> str:
        return os.path.join(self.data_dir(dataset), "all_final.tsv")

    def users(self, dataset: str) -> str:
        return os.path.join(self.data_dir(dataset), "users.tsv")

    def items(self, dataset: str) -> str:
        return os.path.join(self.data_dir(dataset), "items.tsv")

    def training_set(self, dataset: str) -> str:
        return os.path.join(self.data_dir(dataset), "trainingset.tsv")

    def validation_set(self, dataset: str) -> str:
        return os.path.join(self.data_dir(dataset), "validationset.tsv")

    def test_set(self, dataset: str) -> str:
        return os.path.join(self.data_dir(dataset), "testset.tsv")

    def dataset_info(self, dataset: str) -> str:
        return os.path.join(self.data_dir(dataset), "stats_after_downloading")

    def original(self, dataset: str) -> str:
        return os.path.join(self.data_dir(dataset), "original")

    def images(self, dataset: str) -> str:
        return os.path.join(self.original(dataset), "images")

    # --- feature artifacts (configs.py:16-29) ---
    def classes_csv(self, dataset: str, cnn_model: str) -> str:
        return os.path.join(self.original(dataset), f"classes_{cnn_model}.csv")

    def cnn_features(self, dataset: str, cnn_model: str, output_layer: str) -> str:
        return os.path.join(
            self.original(dataset), f"cnn_features_{cnn_model}_{output_layer}.npy"
        )

    def cnn_features_split_dir(
        self, dataset: str, cnn_model: str, output_layer: str
    ) -> str:
        return os.path.join(
            self.original(dataset), "features", f"cnn_{cnn_model}_{output_layer}"
        )

    def edge_features(self, dataset: str, cnn_model: str, output_layer: str) -> str:
        return os.path.join(
            self.original(dataset), f"edge_features_{cnn_model}_{output_layer}.npy"
        )

    def color_features(self, dataset: str) -> str:
        return os.path.join(self.original(dataset), "color_features.npy")

    def texture_features(self, dataset: str, cnn_model: str) -> str:
        """Gram-matrix texture features (reference configs.py:21, consumed
        via OLD_visual_loader_mixin.py:35-42 by CompVBPR)."""
        return os.path.join(
            self.original(dataset), f"texture_features_{cnn_model}.npy"
        )

    def features_dir(self, dataset: str) -> str:
        return os.path.join(self.original(dataset), "features")

    def hist_color_features(self, dataset: str) -> str:
        return os.path.join(self.features_dir(dataset), "histograms.npy")

    def hist_color_features_dir(self, dataset: str) -> str:
        return os.path.join(self.features_dir(dataset), "color_histograms")

    def class_features(self, dataset: str) -> str:
        return os.path.join(self.features_dir(dataset), "one_hot_enc.npy")

    def class_features_dir(self, dataset: str) -> str:
        return os.path.join(self.features_dir(dataset), "one_hot_encodings")

    def colors_dir(self, dataset: str) -> str:
        return os.path.join(self.features_dir(dataset), "colors")

    def edges_dir(self, dataset: str) -> str:
        return os.path.join(self.features_dir(dataset), "edges")

    def edges_stack(self, dataset: str) -> str:
        """Single-file float32 stack of the per-item edge tiffs
        (data/pipeline.py::build_edge_stack_npy) — memmap-consumed by the
        streamed >HBM trainer (cli/train_rec.py --streamed)."""
        return os.path.join(self.features_dir(dataset), "edges_stack.npy")

    # --- results (configs.py:32-33) ---
    def weight_dir(self, dataset: str, rec: str) -> str:
        return os.path.join(self.results_root, "rec_model_weights", dataset, rec)

    def results_dir(self, dataset: str, rec: str) -> str:
        return os.path.join(self.results_root, "rec_results", dataset, rec)


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout: `data` is the batch axis, `model` the table-row axis."""

    data: int = 1
    model: int = 1

    @property
    def num_devices(self) -> int:
        return self.data * self.model


@dataclass(frozen=True)
class TrainConfig:
    """Shared training hyperparameters (reference src/train_rec.py:19-44)."""

    dataset: str = "amazon_baby"
    rec: str = "bprmf"
    batch_size: int = 256
    top_k: int = 20
    epochs: int = 200
    verbose: int = -1  # checkpoint every N epochs; -1 disables
    batch_eval: int = 128
    lr: float = 0.001
    validation: bool = True
    restore_epochs: int = 1
    reg: float = 0.0
    best_metric: str = "ndcg"
    seed: int = 0
    eval_every: int = 1  # evaluate every N epochs (reference evaluates every epoch)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    paths: Paths = field(default_factory=Paths)
    # numeric precision of the compute path; params stay float32
    compute_dtype: str = "float32"
    # "generic": take-VJP + dense TF-parity Adam (reference optimizer
    # semantics).  "packed": packed-state rows + LazyAdam (train/packed.py)
    # — the fastest single-chip path at large table counts; available for
    # bprmf/vbpr, single-device.
    train_path: str = "generic"
    # with-replacement triple sampling (original-BPR bootstrap scheme);
    # False = the no-replacement scheme selected by `sampling`
    bootstrap: bool = False
    # no-replacement epoch ordering: "user_perm" = the reference's exact
    # scheme (shuffle users, visit each user's positives in stored order,
    # dataset.py:94-99); "pair_perm" = permute the full interaction list
    # (mixes strictly better, costs an N-element sort)
    sampling: str = "user_perm"

    @property
    def sampling_scheme(self) -> str:
        """The effective sample_triplets scheme for this config."""
        return "bootstrap" if self.bootstrap else self.sampling
    # single-device packed path: fold frozen per-item feature columns into
    # the packed item rows (models declaring PackedSpec.frozen_item_tables:
    # vbpr/grad_fashion/acf), halving the row gathers per step.  Value-
    # identical; costs one extra HBM copy of those tables — disable when
    # the feature matrix doesn't fit twice.
    fused_frozen: bool = True
    # packed path: Adam moment storage — "float32" ([p|m|v] rows) or
    # "bfloat16" (m,v bit-packed as two bf16 halves of one fp32 column:
    # rows shrink 3W+1 -> 2W+1, cutting the bytes-bound scatter traffic
    # ~1/3 at ~8-bit moment mantissas).  Single-device and sharded engines.
    moment_dtype: str = "float32"
    # packed path: on touch, additionally apply the closed-form momentum
    # tail dense Adam would have applied over the skipped steps
    # (train/packed.py::_momentum_catchup) — closes LazyAdam's measured
    # convergence gap (BASELINE.md round 4) at zero extra row ops
    # (throughput-free, SPEED.md).  Default ON since round 4; the raw
    # engine functions default OFF to keep plain-LazyAdam pins unchanged.
    lazy_catchup: bool = True
    # packed path: pad packed-row widths to this multiple (capacity mode).
    # TPU tiled layouts pad the lane dim to 128 anyway, and XLA
    # materializes a fully PADDED transient copy of each whole table at
    # the epoch scan boundary — explicit 128-alignment makes that padding
    # resident instead, cutting peak HBM from ~2.5x to ~1.5x of the
    # logical table (SPEED.md round-5 capacity ladder).  1 = off (default:
    # smaller resident tables, best throughput at sizes that fit).
    row_align: int = 1

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class BPRMFConfig:
    """BPRMF model hyperparameters (reference src/recommender/models/BPRMF.py:23-50)."""

    embed_k: int = 128


@dataclass(frozen=True)
class VBPRConfig(BPRMFConfig):
    """VBPR adds a frozen visual feature matrix with a learned projection
    (reference src/recommender/models/VBPR.py:29-54)."""

    embed_d: int = 20
    cnn_model: str = "vgg19"
    output_layer: str = "fc2"


@dataclass(frozen=True)
class GradFashionConfig(BPRMFConfig):
    """GradFashion: two frozen low-level families (color + edges) with learned
    per-family projections (reference src/recommender/models/GradFashion.py:24-55).

    The reference reads params.embed_color/embed_edges which its CLI never
    defines (GradFashion.py:29-30) — here they are first-class fields.
    """

    embed_d: int = 20
    embed_color: int = 32
    embed_edges: int = 32
    cnn_model: str = "vgg19"
    output_layer: str = "fc2"


@dataclass(frozen=True)
class AttentiveFashionConfig(BPRMFConfig):
    """AttentiveFashion: trainable per-modality encoders + attention
    (reference src/recommender/models/AttentiveFashion.py:22-71)."""

    attention_layers: Tuple[int, ...] = (64, 1)
    encoder_hidden: int = 256
    dropout_rate: float = 0.5


@dataclass(frozen=True)
class ACFConfig(BPRMFConfig):
    """ACF: component- and item-level attention over spatial CNN maps
    (reference src/recommender/models/ACF.py:22-58)."""

    layers_component: Tuple[int, ...] = (64, 1)
    layers_item: Tuple[int, ...] = (64, 1)
    cnn_model: str = "vgg19"
    output_layer: str = "block5_pool"
    # cap on positives per user folded into the attentive user profile;
    # fixed shape for XLA (reference uses ragged lists, ACF.py:140-150)
    max_user_pos: int = 64


MODEL_CONFIGS = {
    "bprmf": BPRMFConfig,
    "vbpr": VBPRConfig,
    "grad_fashion": GradFashionConfig,
    "attentive_fashion": AttentiveFashionConfig,
    "acf": ACFConfig,
}
