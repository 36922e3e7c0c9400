"""Named spans inside the port, on the profiler's own clock.

A span is a ``torch.profiler.record_function`` range, opened only while a
``torch.profiler`` session records: it then lands in the same Kineto
trace as the device activity it launched, on one clock. Without a
running profiler each site is one global read and returns one shared
null context, so the serving path pays nothing else.

The names (:data:`SPANS`), each opened inside the function it names:

  lm.prefill      ``models/lm.py`` ``prefill``: the whole prompt pass
  lm.decode_step  ``models/lm.py`` ``decode_step``: one greedy step
  lm.head         ``models/lm.py`` ``lm_logits``: final norm and LM head
  linear          ``core/engine.py`` ``matmul`` on a packed HiF4 weight:
                  its host dispatch and kernels 1 and 2 (or the decode form)
  attn.prefill    ``models/transformer.py`` ``attn_full``: the flash
                  attention call
  attn.decode     ``models/transformer.py`` ``attn_decode``: the decode
                  attention call (kernel 3 or 4, or the plain recurrence)
  kv.append       ``models/transformer.py`` ``attn_decode``: each KV append
                  call (the HiF4 one; K's and V's for a bf16 cache)
  kv.pack         ``models/lm.py`` ``quantize_kv_cache``: the prefill's KV
                  packed to the HiF4 kernel layout
  ssm.conv        ``models/mamba2.py``: a block's two causal convolutions
  ssd.scan        ``models/mamba2.py`` ``mamba_full``: the chunked SSD scan
  ssd.step        ``models/mamba2.py`` ``mamba_step``: the recurrent SSD step
  moe.experts     ``models/moe.py`` ``moe_apply``: the expert products
"""
from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _profiler

SPANS = ("lm.prefill", "lm.decode_step", "lm.head", "linear", "attn.prefill",
         "attn.decode", "kv.append", "kv.pack", "ssm.conv", "ssd.scan",
         "ssd.step", "moe.experts")

_OFF = contextlib.nullcontext()


def span(name: str):
    """A profiler range named ``name`` while a profiler records, else the
    shared null context."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF
