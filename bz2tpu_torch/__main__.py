import sys

from bz2tpu_torch.cli import main

sys.exit(main())
