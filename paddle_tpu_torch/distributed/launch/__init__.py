"""``python -m paddle_tpu_torch.distributed.launch [flags] train.py
args...``: the elastic launcher, ported from
``paddle_tpu/distributed/launch``. It spawns the workers with the
``PADDLE_*`` environment, keeps a log per rank, and relaunches on a
preemption or a crash (see ``main``). It imports neither torch nor
JAX."""

from .main import launch_main

__all__ = ["launch_main"]
