"""PyTorch + CUDA port of ``repro``: the whole package, on NVIDIA H100s.

* The sparse device path: ``core`` lowers a CSR matrix under an
  ``SpmvPlan`` to a program and runs it on hand-written CUDA kernels
  (``csrc/``, ``kernels/``) for the ell/hyb, seg, split and tile families,
  on one device or over a ``torch.distributed`` mesh, eager or
  graph-replayed.
* Its host layer: the planner and cost oracle, the Emu simulator and
  cache model, partitions, reorderings, artifacts and ``relower``.
* SpMV serving (``serve``): the router and the rebalancer.
* The ten LM architectures of ``repro.configs`` (``models/``,
  ``configs/``) in plain PyTorch: serving (``serve/engine.py``,
  ``launch/serve.py``), training (``optim/``, ``data/``, ``train/``,
  ``launch/train.py``), their sharding over a mesh
  (``models/sharding.py``, ``launch/mesh.py``) and the dry run
  (``launch/dryrun.py``).
* Spans and counters of set-up and of each call (``tracing``).

It imports ``torch`` and ``numpy`` only: no JAX and nothing of ``repro``,
whose host modules it keeps its own copies of under the same module
names.  The ``examples_torch/`` scripts are the reference's examples on
it.  Entry points run on CUDA unless ``device="cpu"`` is passed.
"""
