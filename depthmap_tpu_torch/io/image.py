"""Sequence-numbered output file names.

Restated from ``depthmap_tpu/io/image.py`` (held equal by
tests/test_torch_port_outputs.py): ``basename-NNNN[-suffix].ext``, the
reference's naming of saved outputs.
"""
from __future__ import annotations

import os
import re
from typing import Optional


def get_next_sequence_number(outpath: str,
                             basename: Optional[str] = None) -> int:
    """Smallest unused sequence number in outpath
    (``basename-NNNN[-suffix]``)."""
    result = -1
    if not os.path.isdir(outpath):
        return 0
    pat = re.compile(r"^(?:" + re.escape(basename) + r"-)?(\d+)" if basename
                     else r"^(\d+)")
    for fn in os.listdir(outpath):
        m = pat.match(os.path.splitext(fn)[0])
        if m:
            result = max(result, int(m.group(1)))
    return result + 1


def get_unique_filename(outpath: str, basename: str, ext: str,
                        suffix: str = "") -> str:
    basecount = get_next_sequence_number(outpath, basename)
    if basecount > 0:
        basecount -= 1
    if suffix != "":
        suffix = f"-{suffix}"
    for i in range(500):
        fullfn = os.path.join(outpath,
                              f"{basename}-{basecount + i:04}{suffix}.{ext}")
        if not os.path.exists(fullfn):
            return fullfn
    return os.path.join(outpath, f"{basename}-99999{suffix}.{ext}")
