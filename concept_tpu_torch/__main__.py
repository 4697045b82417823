"""`python -m concept_tpu_torch` → the CLI."""

import sys

from concept_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
