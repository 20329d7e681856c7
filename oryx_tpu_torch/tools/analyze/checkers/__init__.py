"""Checker registry: one instance per checker id, in report order.

The port of the JAX package's ``oryx_tpu/tools/analyze/checkers/__init__.py``
with the checkers that mean something for torch code, under the
reference's ids and versions (a port baseline entry reads like a
reference one). Not ported, because they check JAX tracing or Pallas
sources and the port has neither: jit-recompile, tracer-leak,
compile-on-hot-path, float64-promotion and the five Pallas kernel
checkers. The reference's report order is kept for the rest.
"""

from oryx_tpu_torch.tools.analyze.checkers.blocking import BlockingAsyncChecker
from oryx_tpu_torch.tools.analyze.checkers.locks import LockDisciplineChecker
from oryx_tpu_torch.tools.analyze.checkers.concurrency import (
    BlockingUnderLockChecker,
    LockOrderCycleChecker,
    SharedStateEscapeChecker,
)
from oryx_tpu_torch.tools.analyze.checkers.confkeys import ConfigKeyDriftChecker
from oryx_tpu_torch.tools.analyze.checkers.logstyle import LogDisciplineChecker
from oryx_tpu_torch.tools.analyze.checkers.swallowed import SwallowedExceptionChecker
from oryx_tpu_torch.tools.analyze.checkers.perrowstore import PerRowNdarrayStoreChecker
from oryx_tpu_torch.tools.analyze.checkers.replicated import ReplicatedCollectiveChecker
from oryx_tpu_torch.tools.analyze.checkers.hosttransfer import HostDeviceTransferChecker
from oryx_tpu_torch.tools.analyze.checkers.dtypewidth import DtypeWideningChecker
from oryx_tpu_torch.tools.analyze.checkers.protocolmodel import ProtocolModelDriftChecker

ALL_CHECKERS = (
    BlockingAsyncChecker(),
    LockDisciplineChecker(),
    LockOrderCycleChecker(),
    BlockingUnderLockChecker(),
    SharedStateEscapeChecker(),
    ConfigKeyDriftChecker(),
    LogDisciplineChecker(),
    SwallowedExceptionChecker(),
    PerRowNdarrayStoreChecker(),
    ReplicatedCollectiveChecker(),
    HostDeviceTransferChecker(),
    DtypeWideningChecker(),
    ProtocolModelDriftChecker(),
)

#: checker id -> precision version, recorded per baseline entry so a
#: checker upgrade invalidates stale justifications loudly (core.py).
CHECKER_VERSIONS = {c.id: getattr(c, "version", 1) for c in ALL_CHECKERS}
