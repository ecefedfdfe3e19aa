"""Log lines of the serving fleet (port of the `log` and `error` helpers
of skypilot_tpu/utils/ux_utils.py): one prefixed line on stderr each,
`log` silenced by SKYPILOT_TPU_QUIET=1."""
from __future__ import annotations

import os
import sys

_QUIET = os.environ.get('SKYPILOT_TPU_QUIET', '') == '1'


def log(message: str) -> None:
    if not _QUIET:
        print(f'\x1b[36m»\x1b[0m {message}', file=sys.stderr, flush=True)


def error(message: str) -> None:
    print(f'\x1b[31m✗\x1b[0m {message}', file=sys.stderr, flush=True)
