"""Failure injection for chaos drills.

Only the exception type is ported so far: :class:`~repro_torch.launch.server
.Server` raises it at its ``fail_at`` ticks and re-queues in-flight requests.
The checkpoint/restart training loop comes with the training slice.
"""


class InjectedFailure(RuntimeError):
    pass
