"""The port's kernel ops behind one registry (see :mod:`.registry`).

Importing this package registers every op; no kernel is built or loaded
until a CUDA tensor first reaches one (:mod:`.build`).  The ``registry``
import must stay first: the ops modules import it back out of this
partially-initialized package.
"""
from repro_torch.kernels import registry  # noqa: I001  (must precede ops imports)

from repro_torch.kernels.batched_gather.ops import gather_op
from repro_torch.kernels.decode_attention.ops import decode_op
from repro_torch.kernels.flash_attention.ops import attention_op
from repro_torch.kernels.paged_attention.ops import paged_decode_op
from repro_torch.kernels.ssd_scan.ops import ssd_scan_op

__all__ = ["attention_op", "decode_op", "gather_op", "paged_decode_op", "registry",
           "ssd_scan_op"]
