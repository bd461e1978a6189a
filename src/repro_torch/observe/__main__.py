"""``python -m repro_torch.observe``: see :mod:`repro_torch.observe.report`."""
import sys

from .report import main

if __name__ == "__main__":
    sys.exit(main())
