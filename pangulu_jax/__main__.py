"""`python -m pangulu_jax` == the CLI driver."""

import sys

from pangulu_jax.cli import main

sys.exit(main())
