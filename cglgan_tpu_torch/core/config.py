"""Typed configuration with 1:1 knob parity to the reference entry scripts.

The reference exposes its knobs as module-level globals (reference
``README.md:23-34``, ``CGLGAN/MNIST/main.py:33-62``, ``capgan.py:34-55``).
Here they are a single frozen dataclass shared by every algorithm, with the
same names and default semantics.

The port's own copy of ``cglgan_tpu/core/config.py`` (same fields, defaults,
validation and ``resolved_*`` properties; ``tests/test_torch_port_modules.py``
holds the two equal).  The TPU-named knobs keep their names: ``pallas_dstep``
selects the hand-written CUDA local-D kernel (``ops/fused_dstep.py``) and
``pallas_sweep`` the CUDA local D/G-sweep kernel (``ops/fused_sweep.py``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

# Algorithm registry.  Each name maps 1:1 onto a reference entry script:
#   acgan  -> ACGAN/2DMG/acgan.py, ACGAN/MNIST/acgan.py
#   flgan  -> FLGAN/2DMG/flgan.py, FLGAN/MNIST/flgan.py
#   mdgan  -> MDGAN/2DMG/mdgan.py, MDGAN/MNIST/mdgan.py
#   fegan  -> fegan.py
#   cglgan -> CGLGAN/2DMG/main.py, CGLGAN/MNIST/main.py
#   capgan -> capgan.py, CAPGAN/MNIST/capgan.py
#   mixgan -> mixed-gan.py, CAPGAN/MNIST/mixed-gan.py
ALGOS = ("acgan", "flgan", "mdgan", "fegan", "cglgan", "capgan", "mixgan")

DATASETS = ("2dmg", "mnist", "fashion-mnist", "synthetic-mnist")

# Generator-objective weighting games across the CGL/CAP/Mix family.  The
# reference hard-codes one per script and leaves the others as commented
# alternatives (capgan.py:237-256, mixed-gan.py:268-285); here each is a
# first-class selectable mode:
#   cgl_mean_game : F=(beta.l + gamma.l)/2, manual Lambda ascent  (CGLGAN main.py:279-292)
#   cap_exp       : alpha=softmax(softmax(L*l)*beta), F=alpha.l-0.001L (capgan.py:247-249)
#   mix_bll       : alpha=softmax(beta*L*l),          F=alpha.l-0.001L (mixed-gan.py:276-277)
#   beta_gamma    : s=softmax(beta*gamma)             (CAPGAN/MNIST variants :241-243)
#   beta          : F=beta.l                          (commented "beta" branch)
#   gamma         : F=gamma.l-0.001L                  (commented "gamma" branch)
#   mean          : F=sum(l)  (== MD-GAN when num_servers==1; commented branch)
WEIGHTINGS = ("cgl_mean_game", "cap_exp", "mix_bll", "beta_gamma", "beta",
              "gamma", "mean")


@dataclass(frozen=True)
class FedGANConfig:
    """One config object for all seven algorithms.

    Knob names follow the reference globals exactly (``num_workers``,
    ``num_servers``, ``E``, ``num_class``, ``num_sample``, ``batch_size``,
    ``frac_workers``, ``epoch``, ``iid``, ``cloud_epoch``, ``segema``,
    ``num_communication``, ``b1``/``b2``, ``img_size``, ``num_plt``).
    """

    algo: str = "capgan"
    dataset: str = "2dmg"

    # --- topology (reference README.md:23-28) ---
    num_workers: int = 10          # federated clients (each owns one D)
    num_servers: int = 1           # edge servers (each owns one G)
    frac_workers: float = 1.0      # participation fraction per round
    E: int = 0                     # gossip/D-share period in rounds; 0 = off

    # --- data (reference README.md:29-31) ---
    num_class: int = 10
    num_sample: int = 1000         # 2DMG: samples per class; MNIST: eval pool
    iid: int = 1                   # 0 iid / 1 basic non-iid / 2 fully non-iid
    batch_size: int = 100
    img_size: int = 28

    # --- schedule ---
    num_communication: int = 20000  # total federated rounds
    epoch: int = 1                  # local iterations between syncs
    cloud_epoch: int = 1            # rounds between cloud trunk syncs
    segema: float = 0.0             # sigma-mix: 1=fully local, 0=fully shared
    num_plt: int = 500              # eval cadence in rounds

    # --- optimisation (reference CGLGAN/MNIST/main.py:59-60, capgan.py:52-53) ---
    lr_g: float = 2e-4
    lr_d: float = 2e-4
    b1: float = 0.5
    b2: float = 0.999
    lr_lambda: float = 0.1          # SGD lr for the Lambda game variable
    latent_dim: int = 100

    # --- variant switches ---
    weighting: Optional[str] = None  # None -> per-algo default (see below)
    # FL-GAN local-sweep semantics differ per workload in the reference:
    # 2DMG trains `epoch` *batches* per round (FLGAN/2DMG/flgan.py:231-256),
    # MNIST trains `epoch` full local *epochs* (FLGAN/MNIST/flgan.py:249-269).
    local_sweep: Optional[str] = None  # "batches" | "epochs"; None -> by dataset
    # Discriminator head: "sigmoid" (1-logit + BCE) or "logits2" (2-logit + CE).
    d_head: Optional[str] = None
    # MD-GAN every-E-rounds D-swap flavour: "ring" (deterministic shift —
    # a point-to-point collective-permute on a sharded clients axis) or
    # "shuffle" (seeded random permutation per swap event — the reference's
    # commented semantics, MDGAN/MNIST/mdgan.py:158-164; multi-chip it
    # lowers to an all-gather since the permutation is data-dependent).
    d_swap: str = "ring"
    # AC-GAN every-E-rounds gossip flavour: "mean" (clients of one server
    # replace their Ds with the block mean) or "delta" (the strict-fidelity
    # delta-accumulating exchange of the reference's commented sketch,
    # ACGAN/MNIST/acgan.py:240-263 — per-member anchors, block-averaged
    # deltas; coincides with "mean" at the first exchange event, see
    # fed/collectives.py delta_share_tree).
    gossip: str = "mean"
    conv: bool = False              # use the conv LSGAN G/D pair (model/lsgan.py)

    # --- fault simulation (TPU-build extension; SURVEY.md §5 suggests
    # straggler/dropout simulation via sampling masks — the reference has
    # no fault handling beyond isAlive() liveness polls) ---
    dropout_rate: float = 0.0   # P(client misses a round); flgan/mdgan/acgan/
                                # fegan only — the CGL-family protocol blocks
                                # on every client by construction

    # --- runtime ---
    # tensor parallelism: shard generator weights column-wise over a `model`
    # mesh axis (SURVEY.md §2.2 — absent in the reference, exposed for
    # large-G scaling).  1 = off; >1 requires a mesh with a `model` axis of
    # this size (core.meshes.fed_mesh).
    model_shards: int = 1
    # fused local-D-epoch kernel (ops/fused_dstep.py, CUDA C++).  None =
    # auto (on when eligible and epoch > 1), True = force (errors if the
    # config is ineligible), False = never.  Float-tolerance parity with
    # the autograd path (sums run in another order), not bit parity.  The
    # knob keeps the reference's TPU name.
    pallas_dstep: Optional[bool] = None
    # fused local D/G-sweep kernel for the FedAvg family
    # (ops/fused_sweep.py, CUDA C++): runs all ``epoch`` interleaved
    # (D step, G step) local iterations of every worker in one call.  2DMG
    # flgan/fegan only.  The reference's rule is kept: None/False = off,
    # True = force (errors if the config is ineligible); PERF.md has the
    # card's numbers for both paths.
    pallas_sweep: Optional[bool] = None
    seed: int = 20211212
    # param/activation dtype; losses and the Lambda game stay float32.
    # Default float32 matches the reference's torch numerics; "bfloat16"
    # runs every algorithm with JAX's bf16 rounding rules (``core/dtypes.py``).
    dtype: str = "float32"
    # bfloat16 + 2DMG is refused at construction, with the reference's
    # message: the JAX package measured the fidelity loss (bf16's ~3
    # significant digits cannot place outputs inside the task's 0.01-std
    # clusters).  Set True to pass construction anyway.
    force_dtype: bool = False
    scan_rounds: int = 0            # rounds fused per lax.scan chunk; 0 = auto
    data_dir: Optional[str] = None  # IDX files for real MNIST, if available

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.algo not in ALGOS:
            raise ValueError(f"unknown algo {self.algo!r}; expected one of {ALGOS}")
        if self.dataset not in DATASETS:
            raise ValueError(f"unknown dataset {self.dataset!r}")
        if self.iid not in (0, 1, 2):
            raise ValueError("iid must be 0, 1 or 2")
        if self.num_workers % max(self.num_servers, 1) != 0:
            # Reference block assignment drops the remainder
            # (CGLGAN/MNIST/main.py:507-513); we require divisibility so no
            # client is silently orphaned.
            raise ValueError("num_workers must be divisible by num_servers")
        if self.weighting is not None and self.weighting not in WEIGHTINGS:
            raise ValueError(f"unknown weighting {self.weighting!r}")
        if self.dropout_rate and self.algo in ("cglgan", "capgan", "mixgan"):
            raise ValueError(
                "dropout_rate is not supported for the CGL family: the "
                "reference protocol blocks on every client's loss each round")
        if not 0.0 <= self.dropout_rate < 1.0:
            raise ValueError("dropout_rate must be in [0, 1)")
        if self.model_shards < 1:
            raise ValueError("model_shards must be >= 1")
        if self.model_shards > 1 and self.algo not in ("cglgan", "capgan",
                                                       "mixgan"):
            raise ValueError(
                "model_shards > 1 (tensor parallelism) is wired into the "
                "CGL-family generator placement only; other algos would "
                "silently leave the model axis idle")
        if self.d_swap not in ("ring", "shuffle"):
            raise ValueError("d_swap must be 'ring' or 'shuffle'")
        if self.gossip not in ("mean", "delta"):
            raise ValueError("gossip must be 'mean' or 'delta'")
        if (self.dtype == "bfloat16" and self.dataset == "2dmg"
                and not self.force_dtype):
            raise ValueError(
                "dtype='bfloat16' degrades 2DMG fidelity: measured "
                "Distribution Score 0.03 vs 0.91 (float32) at 8k rounds "
                "(PERF.md, 'bfloat16 mode' — ~3 significant digits of "
                "weight precision cannot hit the 0.01-std clusters).  Use "
                "float32 for 2DMG, or set force_dtype=True / --force-dtype "
                "to run it anyway")

    # ------------------------------------------------------------------
    @property
    def clients_per_server(self) -> int:
        return self.num_workers // self.num_servers

    @property
    def is_image(self) -> bool:
        return self.dataset != "2dmg"

    @property
    def img_shape(self):
        return (2,) if self.dataset == "2dmg" else (1, self.img_size, self.img_size)

    @property
    def resolved_weighting(self) -> str:
        if self.weighting is not None:
            return self.weighting
        return {"cglgan": "cgl_mean_game", "capgan": "cap_exp",
                "mixgan": "mix_bll"}.get(self.algo, "mean")

    @property
    def resolved_local_sweep(self) -> str:
        if self.local_sweep is not None:
            return self.local_sweep
        return "epochs" if (self.algo in ("flgan", "fegan") and self.is_image) else "batches"

    @property
    def resolved_d_head(self) -> str:
        """Reference loss choice per variant: BCE+sigmoid everywhere except the
        CAP/Mix MNIST workers, which use CrossEntropy on a 2-logit D
        (capgan.py:311, mixed-gan.py:349, model/mnist_model.py:81)."""
        if self.d_head is not None:
            return self.d_head
        if self.algo in ("capgan", "mixgan") and self.is_image:
            return "logits2"
        if self.algo == "acgan" and self.is_image:
            return "logits2"   # ACGAN/MNIST/acgan.py uses CE on 2 logits
        return "sigmoid"

    def replace(self, **kw) -> "FedGANConfig":
        return dataclasses.replace(self, **kw)
