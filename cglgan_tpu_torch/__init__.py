"""PyTorch/CUDA port of ``cglgan_tpu`` for one NVIDIA H100.

The JAX package beside it is the reference; this package mirrors its module
names (``core data models fed algos ops utils``) and imports nothing from it
and nothing of JAX.  Stacked layout as in the reference: generator state is
stacked ``(S, ...)`` over edge servers, discriminator state ``(W, ...)`` over
clients, linear weights are ``(din, dout)``.

Entry points (``algos.registry.build_runner``, ``Runner.init_state``,
``Runner.round_fn``, ``algos.runner.train``) run on ``cuda`` unless the
caller passes ``device="cpu"``.  The local-D phase at ``epoch > 1`` runs the
hand-written CUDA kernel in ``ops/csrc/fused_dstep.cu``.

Nothing is imported eagerly: ``import cglgan_tpu_torch`` loads no torch.
"""
