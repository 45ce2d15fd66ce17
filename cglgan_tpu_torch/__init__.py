"""PyTorch/CUDA port of ``cglgan_tpu`` for one NVIDIA H100.

The JAX package beside it is the reference; this package mirrors its module
names (``core data models fed algos evalx ops utils``) and imports nothing
from it and nothing of JAX.  Stacked layout as in the reference: for the CGL
family (CGL-GAN, CAP-GAN, Mix-G) generator state is stacked ``(S, ...)`` over
edge servers (a multipath G's heads ``(S, k, ...)``) and discriminator state
``(W, ...)`` over clients; for FL-GAN and FeGAN params are global and
the per-worker Adam state is stacked ``(W, ...)``; linear weights are
``(din, dout)``.

Entry points (``algos.registry.build_runner``, ``Runner.init_state``,
``Runner.round_fn``, ``algos.runner.train``) run on ``cuda`` unless the
caller passes ``device="cpu"``.  The CGL family's local-D phase at
``epoch > 1`` runs the hand-written CUDA kernel in
``ops/csrc/fused_dstep.cu`` (image or 2DMG rows, shared or per-client
fakes); the
FedAvg family's local sweep runs ``ops/csrc/fused_sweep.cu`` when
``pallas_sweep=True``; ``ops/csrc/fused_adam.cu`` is a fused Adam step that
no algorithm calls, as in the reference.

Nothing is imported eagerly: ``import cglgan_tpu_torch`` loads no torch.
"""
