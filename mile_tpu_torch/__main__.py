import sys

from mile_tpu_torch.cli import main

sys.exit(main())
