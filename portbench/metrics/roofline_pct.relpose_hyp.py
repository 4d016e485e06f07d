"""The relative pose's four hypothesis, vote and scoring kernels
(``csrc/relpose_hyp.cu``) against their roofline, in percent: the
operations at 67 TFLOP/s (float32) or the bytes at 3.35 TB/s, whichever
bounds each call, over the kernels' device time in the traced window."""

from portbench.frozen.work import hyp_work
from portbench.readers import roofline_pct

_POINTS = ("essential_hypotheses", "homography_hypotheses", "homography_polish", "recover_pose", "score_candidates")
RECORD = tuple(f"meatmodeler_tpu_torch.geometry.ransac:{name}" for name in _POINTS)
KERNELS = ("essential_hypotheses_kernel", "homography_hypotheses_kernel", "recover_pose_kernel",
           "score_candidates_kernel")


def read(ctx):
    rec = ctx["recorded"]
    work = [hyp_work(name, args) for name in _POINTS for args in rec.get(name, ())]
    return roofline_pct(ctx, KERNELS, [(w["flops"], w["bytes"]) for w in work])
