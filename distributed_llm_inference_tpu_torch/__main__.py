"""``python -m distributed_llm_inference_tpu_torch`` → the port's CLI
(subcommands info / local / api; see ``cli.py``)."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
