"""``python -m paddle_tpu_torch.distributed.launch``: the job launcher,
single-node collective mode (:mod:`.controller`)."""

from .context import Context  # noqa: F401
from .controller import CollectiveController, launch  # noqa: F401
from .job import Container, Pod, kill_group  # noqa: F401
from .master import Master  # noqa: F401
