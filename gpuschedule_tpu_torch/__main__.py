"""``python -m gpuschedule_tpu_torch ...`` — the same CLI as ``cli.main``."""

import sys

from gpuschedule_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
