"""The examples' shared command line: ``--device`` (``cuda`` unless the
caller asks for the CPU; no GPU raises) and ``--smoke`` (fewer rows,
trees and epochs, never other widths or bins)."""

from __future__ import annotations

import argparse
from typing import List, Optional

from dmlc_core_tpu_torch.utils.device import resolve_device


def parse(doc: str, argv: Optional[List[str]] = None,
          worker: bool = False) -> argparse.Namespace:
    """The example's arguments; ``device`` is the resolved device's
    string, so a missing GPU raises before any work starts.  ``worker``
    adds ``--worker``: the entry of the processes an example starts."""
    p = argparse.ArgumentParser(
        description=doc.strip().splitlines()[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("--smoke", action="store_true",
                   help="a short run: fewer rows, trees and epochs")
    if worker:
        p.add_argument("--worker", action="store_true",
                       help="(internal) run as one of the example's workers")
    args = p.parse_args(argv)
    args.device = str(resolve_device(args.device))
    return args
