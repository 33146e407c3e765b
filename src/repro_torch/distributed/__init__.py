"""``repro_torch.distributed``: expert and data parallelism over
``torch.distributed`` ranks, as ``repro.distributed``.

Module map
----------
``context.py``      :class:`DistContext` (the ``(dp, ep)`` mesh's rank
                    layout and process groups), ``init_distributed``,
                    ``make_context``, ``make_serving_context``,
                    ``ep_split``.
``collectives.py``  the collectives of the MoE layer as autograd
                    functions (All-to-All, sequence scatter and gather,
                    the ZeRO-3 gather, the ``pmean``), each with its
                    transpose as backward.
``compression.py``  int8 gradient compression with error feedback.
"""
from repro_torch.distributed.context import (DistContext, ep_split,
                                             init_distributed, make_context,
                                             make_serving_context)

__all__ = ["DistContext", "ep_split", "init_distributed", "make_context",
           "make_serving_context"]
