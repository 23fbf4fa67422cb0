"""``python -m debvader_tpu_torch <command>``: see cli.py."""

import sys

from debvader_tpu_torch.cli import main

sys.exit(main())
