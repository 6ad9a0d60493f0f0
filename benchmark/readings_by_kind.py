"""``benchmark.readings`` for a traffic kind whose module brings its own
control: the same arguments and output, the control's numbers from the
kind's ``control_numbers(run)`` where its module has one
(``readings.control_numbers`` writes the batch and stream kinds' only).

    python3 -m benchmark.readings_by_kind --workload <cell> --seeds 1,2,3
        [--control-seeds 4,5,6] [--seconds 20] [--out PATH]
"""

import sys

from . import readings, spec as spec_mod

_BUILT_IN = readings.control_numbers


def control_numbers(run) -> dict:
    own = getattr(spec_mod.kind_module(run.traffic["kind"]),
                  "control_numbers", None)
    return own(run) if own is not None else _BUILT_IN(run)


if __name__ == "__main__":
    readings.control_numbers = control_numbers
    sys.exit(readings.main())
