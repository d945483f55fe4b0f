import sys

from heatmap_tpu_torch.cli import main

sys.exit(main())
