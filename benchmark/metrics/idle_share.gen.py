"""Share of a steady traced stretch in which no operation ran on the
device (``readers.idle_share``): ``trace_units`` whole requests under the
profiler's device-only trace, busy time the union of the device's
operations. The profiler pays a few microseconds on the host for every
launch, so where the host paces the loop the stretch reads more idle than
an untraced window would."""
from benchmark.harness.readers import idle_share as read  # noqa: F401
