"""``python -m imageencoder_tpu_torch <settings.conf> [options]``: the
port's CLI (cli.py)."""

from .cli import main

raise SystemExit(main())
