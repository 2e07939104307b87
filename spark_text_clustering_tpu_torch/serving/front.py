"""What one serve replica needs of the serve fleet's front: the response
attribution and affinity headers, and the publish-order stamp of a model
dir (the JAX package's ``serving/front.py``, these parts copied).  The
routing front itself comes with the serve fleet.
"""

from __future__ import annotations

import os
import re
from typing import Optional

__all__ = [
    "model_stamp",
    "REPLICA_HEADER",
    "GENERATION_HEADER",
    "STREAM_HEADER",
    "PRIORITY_HEADER",
    "DEGRADED_HEADER",
]

# response attribution / affinity headers (the serve replica stamps
# GENERATION_HEADER itself; the front adds REPLICA_HEADER and reads
# STREAM_HEADER for pinning).  PRIORITY_HEADER carries the request's
# class (interactive | batch) front -> replica -> coalescer;
# DEGRADED_HEADER comes back from a replica that answered under
# degraded mode and is forwarded to the client verbatim.
REPLICA_HEADER = "X-STC-Replica"
GENERATION_HEADER = "X-STC-Generation"
STREAM_HEADER = "X-STC-Stream"
PRIORITY_HEADER = "X-STC-Priority"
DEGRADED_HEADER = "X-STC-Degraded"

_STAMP_RE = re.compile(r"_(\d+)$")


def model_stamp(path: Optional[str]) -> Optional[int]:
    """The publish-order stamp embedded in a model dir's basename
    (``LdaModel_EN_1723456789``): the total order rolling swaps and
    generation pinning ride.  None for unstamped paths."""
    if not path:
        return None
    m = _STAMP_RE.search(os.path.basename(os.path.normpath(path)))
    return int(m.group(1)) if m else None
