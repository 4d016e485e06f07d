"""CLAHE's two kernels (``csrc/clahe.cu``) against their byte roofline, in
percent: each input read once and each output written once at 3.35 TB/s,
over the kernels' device time in the traced window."""

from portbench.frozen.work import clahe_apply_bytes, clahe_lut_bytes
from portbench.readers import roofline_pct

RECORD = ("meatmodeler_tpu_torch.ops.clahe_cuda:clahe_lut", "meatmodeler_tpu_torch.ops.clahe_cuda:clahe_apply")


def read(ctx):
    rec = ctx["recorded"]
    work = [(0, clahe_lut_bytes(tuple(a[0].shape), tuple(a[2]))) for a in rec.get("clahe_lut", ())]
    work += [(0, clahe_apply_bytes(tuple(a[0].shape), tuple(a[2]))) for a in rec.get("clahe_apply", ())]
    return roofline_pct(ctx, ("clahe_lut_kernel", "clahe_apply_kernel"), work)
