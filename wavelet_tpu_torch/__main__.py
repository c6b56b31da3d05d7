"""``python -m wavelet_tpu_torch`` == ``python -m wavelet_tpu_torch.cli``."""

import sys

from wavelet_tpu_torch.cli import main

sys.exit(main())
