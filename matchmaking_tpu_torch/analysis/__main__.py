"""``python -m matchmaking_tpu_torch.analysis`` — run matchlint over the
port."""

import sys

from matchmaking_tpu_torch.analysis.engine import main

if __name__ == "__main__":
    sys.exit(main())
