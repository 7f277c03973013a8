"""PyTorch/CUDA port of mvsdf_tpu for one NVIDIA H100.

The JAX package ``mvsdf_tpu`` is the reference this package is held
against; nothing here imports it or JAX. The module layout mirrors it:
``fields/``, ``geometry/``, ``tracing/`` (with the hand-written CUDA kernels
under ``tracing/kernels/``), ``rendering/``, ``supervision/``, ``train/``,
``parallel/`` (data parallelism over ``torch.distributed``), ``eval/``
(with the serving export), ``data/``, ``meshcut/``, ``config.py`` and
``compaction.py``; beside them ``bench.py`` and ``graft_entry.py``, the
counterparts of the JAX repo's ``bench.py`` and ``__graft_entry__.py``.

Entry points (``train.step.init_params``, ``init_train_state``) run on
``cuda`` unless the caller passes ``device="cpu"``; every other function
follows the device of the tensors it is given.
"""
