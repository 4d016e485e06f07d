"""The BA Jacobian kernel (``csrc/ba_jac.cu::obs_jacobians_kernel``) against
its byte roofline, in percent: each input read once and each Jacobian row
written once (``portbench/ba_work.py``) at 3.35 TB/s, over the kernel's
device time in the traced window; every launch counts, the board poses'
pose-only LM and the batched LM's alike."""

from portbench.ba_work import obs_jacobians_bytes
from portbench.readers import roofline_pct

RECORD = ("meatmodeler_tpu_torch.solvers.bundle_adjust_cuda:obs_jacobians",)


def read(ctx):
    work = [(0, obs_jacobians_bytes(a)) for a in ctx["recorded"].get("obs_jacobians", ())]
    return roofline_pct(ctx, ("obs_jacobians_kernel",), work)
