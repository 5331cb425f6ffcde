"""The port's pod-axis split pipeline (``core.splitter.
split_pipeline_podwise``) and ``runtime/multipod_demo.py`` against the
reference (``tests/test_moe_pipeline.py``'s two pipeline tests and
``examples/multipod_split_demo.py``).

The reference runs on four forced host devices, so ONE forked run gives
its pipeline outputs (fp32 and INT8 wire) on the tests' inputs and its
example's printed lines.  The port runs the same (pod 2, data 2) mesh
over the CPU named four times: the fp32 wire equals the sequential
stack to float32 rounding (the reference test's 1e-5) and the
reference's output at 1e-6; the INT8 wire stays within the reference
test's 0.05 of the sequential stack, and the demo prints the example's
numbers to the printed precision (the INT8 error within one of its
quantization steps: the two ``fake_quant``s round the same operations
in another order, ROADMAP §3).
"""
import json
import os

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.splitter import split_pipeline_podwise  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.runtime import multipod_demo  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_REFERENCE = """
import contextlib, io, json, runpy, jax, jax.numpy as jnp, numpy as np
from repro.launch.mesh import make_test_mesh
from repro.core.splitter import split_pipeline_podwise
mesh = make_test_mesh((2, 2), ('pod', 'data'))
W = jax.random.normal(jax.random.PRNGKey(0), (2, 16, 16)) * 0.3
x = jax.random.normal(jax.random.PRNGKey(1), (3, 4, 16))
def stage_fn(w, h):
    return jnp.tanh(h @ w)
out = {str(q): np.asarray(split_pipeline_podwise(
           mesh, stage_fn, W, x, quantize_wire=q, batch_axes='data')).tolist()
       for q in (False, True)}
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    runpy.run_path(@EXAMPLE@, run_name='__main__')
out['example'] = buf.getvalue().splitlines()
print('JSON' + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    from conftest import run_python
    path = os.path.join(REPO, "examples", "multipod_split_demo.py")
    out = run_python(_REFERENCE.replace("@EXAMPLE@", repr(path)), devices=4)
    line = next(x for x in out.splitlines() if x.startswith("JSON"))
    return json.loads(line[4:])


def mesh4():
    return make_test_mesh((2, 2), ("pod", "data"), devices=["cpu"] * 4)


def stage_fn(w, h):
    return torch.tanh(h @ w)


def inputs():
    W = np.array(jax.random.normal(jax.random.PRNGKey(0), (2, 16, 16))) * 0.3
    x = np.array(jax.random.normal(jax.random.PRNGKey(1), (3, 4, 16)))
    W, x = torch.from_numpy(W), torch.from_numpy(x)
    return W, x, torch.tanh(torch.tanh(x @ W[0]) @ W[1])


def test_split_pipeline_podwise_matches_sequential(reference):
    """fp32 wire: the pipeline == the sequential stages (1e-5) and the
    reference's pipeline (1e-6)."""
    W, x, want = inputs()
    out = split_pipeline_podwise(mesh4(), stage_fn, W, x,
                                 quantize_wire=False, batch_axes="data")
    assert out.shape == x.shape
    err = float((out - want).abs().max())
    print("pipeline err", err)
    assert err < 1e-5
    np.testing.assert_allclose(out.numpy(), np.float32(reference["False"]),
                               atol=1e-6)


def test_split_pipeline_int8_wire(reference):
    """INT8 wire: quantization noise only (the reference test's 0.05),
    and within it of the reference's pipeline."""
    W, x, want = inputs()
    out = split_pipeline_podwise(mesh4(), stage_fn, W, x,
                                 quantize_wire=True, batch_axes="data")
    rel = float((out - want).abs().max())
    print("int8 wire err", rel)
    assert rel < 0.05
    theirs = np.float32(reference["True"])
    assert float(np.abs(out.numpy() - theirs).max()) < 0.05


def test_pipeline_pods_on_one_device_and_batch_axes():
    """Without a data axis the whole microbatch rides one pod pair; the
    result is the same, and a pod axis that is not 2 is refused."""
    W, x, want = inputs()
    pods = make_test_mesh((2,), ("pod",), devices=["cpu"] * 2)
    out = split_pipeline_podwise(pods, stage_fn, W, x, quantize_wire=False,
                                 batch_axes=())
    assert float((out - want).abs().max()) < 1e-5
    with pytest.raises(ValueError):
        split_pipeline_podwise(make_test_mesh((4,), ("pod",),
                                              devices=["cpu"] * 4),
                               stage_fn, W, x)


def test_multipod_demo_matches_reference_example(reference):
    """The demo on the example's own weights and inputs prints the
    example's lines: fp32 error 0 to the printed precision, the INT8
    error within one quantization step of the example's, the same KB."""
    W = np.array(0.2 * jax.random.normal(jax.random.PRNGKey(0), (2, 64, 64)))
    x = np.array(jax.random.normal(jax.random.PRNGKey(1), (6, 8, 64)))
    lines = []
    res = multipod_demo.main("cpu", W=torch.from_numpy(W),
                             x=torch.from_numpy(x), out=lines.append)
    theirs = reference["example"]
    assert len(lines) == len(theirs) == 3
    assert lines[0] == theirs[0]                    # fp32 wire
    ours_err = res["INT8"]["max_err"]
    their_err = float(theirs[1].split("max err ")[1].split()[0])
    step = float(np.abs(np.tanh(np.tanh(x @ W[0]) @ W[1])).max()) / 127
    assert abs(ours_err - their_err) <= step, (ours_err, their_err)
    assert lines[1].split("(")[1] == theirs[1].split("(")[1]   # KB
    print("demo:", lines[:2], "example:", theirs[:2])
