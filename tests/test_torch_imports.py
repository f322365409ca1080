"""The port never imports jax: not directly, not through the JAX package's
``__init__`` (which imports ``ops`` and with it jax). Checked in a fresh
interpreter that imports the port and runs ``OdometryPipeline.run_staged``
on the CPU."""

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

SCRIPT = """
import sys
import numpy as np
import torch
torch.set_num_threads(1)
import uasl_motion_estimation_tpu_torch
from uasl_motion_estimation_tpu_torch._shared import synthetic
from uasl_motion_estimation_tpu_torch.models.pipeline import OdometryPipeline, default_config
from uasl_motion_estimation_tpu_torch.ops.geometry import Intrinsics
rig = synthetic.CameraRig(fu=320.0, fv=320.0, cu=160.0, cv=96.0, baseline=0.54,
                          height=96, width=160)
seq = synthetic.SyntheticStereoSequence(n_frames=3, rig=rig, seed=0, tex_size=256)
cfg = default_config(Intrinsics(rig.fu, rig.fv, rig.cu, rig.cv), rig.baseline,
                     image_shape=(96, 160))._replace(max_features=64)
pipe = OdometryPipeline(cfg, seed=0, device="cpu")
ls, rs = pipe.stage_frames([seq.frame(i) for i in range(3)])
traj = pipe.run_staged(ls, rs, chunk=2)
assert traj.shape == (3, 4, 4) and np.isfinite(traj).all()
loaded = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib")))
loaded += sorted(m for m in sys.modules if m.startswith("uasl_motion_estimation_tpu.")
                 or m == "uasl_motion_estimation_tpu")
print("LOADED", loaded)
sys.exit(1 if loaded else 0)
"""


def test_port_runs_without_importing_jax():
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout
