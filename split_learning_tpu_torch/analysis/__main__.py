"""``python -m split_learning_tpu_torch.analysis <paths...>``"""

import sys

from split_learning_tpu_torch.analysis.engine import main

if __name__ == "__main__":
    sys.exit(main())
