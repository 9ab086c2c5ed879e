"""Where the task2 trainer-parity runs part, on the CPU: prints each train
step's loss in both packages, then the first step's loss and gradients
from one init on one batch, in the port, in ``laff_tpu``, in ``laff_tpu``
with flax's BatchNorm on its two-pass variance, and in the port's forward
in float64, and last the two-pass reference's epoch losses against the
port's. The world and configs are ``tests/test_torch_port_task2.py``'s.

  JAX_PLATFORMS=cpu python tests/torch_port_task2_evidence.py
"""

import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import flax.linen  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import test_torch_port_task2 as T  # noqa: E402
from laff_tpu.engine import trainer as jt  # noqa: E402
from laff_tpu_torch.engine import prepare as pp  # noqa: E402
from laff_tpu_torch.engine import trainer as pt  # noqa: E402
from laff_tpu_torch.engine.checkpoint import checkpoint_payload, save_checkpoint  # noqa: E402
from laff_tpu_torch.engine.weights import from_jax_variables  # noqa: E402
from laff_tpu_torch.models import layers as port_layers  # noqa: E402


def build_world(root):
    T.build_collection(root, T.TRAIN, n_videos=24, caps_per_video=2, seed=0)
    T.build_collection(root, T.VAL, n_videos=12, caps_per_video=1, seed=5)
    T.build_w2v(root)
    objects = {}
    with open(os.path.join(root, T.TRAIN, "TextData", f"{T.TRAIN}.caption.txt")) as fh:
        for line in fh:
            cap_id, caption = line.strip().split(" ", 1)
            objects.setdefault(cap_id.split("#")[0], " ".join(caption.split()[1:]))
    del objects["video3"]
    with open(os.path.join(root, T.TRAIN, "TextData", f"{T.TRAIN}.caption.obj.txt"), "w") as fh:
        fh.write("\n".join(f"{v} {w}" for v, w in objects.items()))


def recording(tag, base, steps):
    class Meter(base):
        def update(self, val, n=1):
            steps[tag].append(float(val))
            super().update(val, n)
    return Meter


def host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def forward64(self, x, generator=None):
    """TransformNet's training forward in float64, every cast left out
    (dropout is off in these configs)."""
    x = x.double()
    fc = self.fc1 if self.fc1 is not None else self.shared_fc
    if fc is not None:
        x = F.linear(x, fc.weight, fc.bias)
    if self.activation is not None:
        x = port_layers._ACTIVATIONS[self.activation](x)
    if self.bn1 is not None:
        x = self._batch_norm(x)
    return x


class TwoPassBatchNorm(flax.linen.BatchNorm):
    use_fast_variance: bool = False


def rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


def main():
    with tempfile.TemporaryDirectory(prefix="task2_evidence_") as root:
        report(root)


def report(root):
    build_world(root)
    T.jax_prepare.load_config = lambda name: T._tiny(T.jax_tiny.config())
    pp.load_config = lambda name, parm="None": T._tiny(T.port_tiny.config())
    steps = {"laff_tpu": [], "port": []}
    jt.AverageMeter = recording("laff_tpu", jt.AverageMeter, steps)
    pt.AverageMeter = recording("port", pt.AverageMeter, steps)

    kw = T._opts(root, task2_intended=1)
    jopt = T.JOptions(model_prefix="t2_j", num_epochs=2, **kw)
    jprep = T.jax_prepare.prepare(jopt)
    spec = jprep.spec
    model = jt.LAFFModel(spec)
    init = jt.init_state(model, spec, jprep, jt.make_optimizer(jprep.config, spec), seed=2)
    batch = next(iter(jprep.train_feed.epoch(0)))
    jres = jt.main(jopt, prepared=jprep)
    popt = pp.Options(model_prefix="t2_p", num_epochs=2, device="cpu", **kw)
    pprep = pp.prepare(popt)
    carried = from_jax_variables(host(init.params), host(init.batch_stats), host(init.schedule))
    popt.pretrained_file_path = os.path.join(root, "init.pt")
    save_checkpoint(checkpoint_payload(carried, pprep.spec, pprep.config, pprep.featurizers,
                                       {}), popt.pretrained_file_path)
    pres = pt.main(popt, prepared=pprep)
    for i, (a, b) in enumerate(zip(steps["laff_tpu"], steps["port"])):
        print(f"step {i}: laff_tpu {a:.7f} port {b:.7f} rel {rel(b, a):.3e}")
    for j, p in zip(jres["history"], pres["history"]):
        print(f"epoch {j['epoch']}: laff_tpu {j['loss']:.6f} port {p['loss']:.6f} rel "
              f"{rel(p['loss'], j['loss']):.3e}")

    # the first step from the init, on the first batch
    txt = {k: v for k, v in batch["txt"].items() if not k.startswith("w2v_")}
    if "w2v_ids" in batch["txt"]:
        txt["w2v"] = (jprep.w2v_table[batch["txt"]["w2v_ids"]].sum(axis=1)
                      / batch["txt"]["w2v_len"][:, None]).astype(np.float32)
    vis = {k: v for k, v in batch["vis"].items() if k != "task2_labels"}
    labels = batch["vis"]["task2_labels"]
    loss_fn = jt.make_loss_fn(spec)

    def jax_loss(params):
        variables = {"params": params, "batch_stats": init.batch_stats}
        if init.schedule:
            variables["schedule"] = init.schedule
        (te, ve, tc, vc), _ = model.apply(
            variables, {k: jnp.asarray(v) for k, v in txt.items()},
            {k: jnp.asarray(v) for k, v in vis.items()}, train=True,
            rngs={"dropout": jax.random.key(0)}, mutable=["batch_stats"],
            method=model.forward_with_concepts)
        return loss_fn(te, ve) + jt._task2_loss(tc, vc, jnp.asarray(labels), spec.task2)

    def port_loss(double):
        m = pp.seeded_model(pprep.spec, 2, pprep.we)
        m.load_state_dict(carried)
        if double:
            m = m.double()
        cast = (lambda t: t.double() if t.is_floating_point() else t) if double else (lambda t: t)
        loss = pt.TrainStep(m, None, pprep.spec).loss(
            {k: cast(torch.from_numpy(v)) for k, v in txt.items()},
            {**{k: cast(torch.from_numpy(v)) for k, v in vis.items()},
             "task2_labels": torch.from_numpy(labels)})
        loss.backward()
        return float(loss), {k: p.grad.double().numpy() for k, p in m.named_parameters()}

    fast, fast_g = jax.value_and_grad(jax_loss)(init.params)
    flax_bn = flax.linen.BatchNorm
    flax.linen.BatchNorm = TwoPassBatchNorm
    two, two_g = jax.value_and_grad(jax_loss)(init.params)
    flax.linen.BatchNorm = flax_bn
    port, port_g = port_loss(False)
    plain_forward = port_layers.TransformNet.forward
    port_layers.TransformNet.forward = forward64
    exact, exact_g = port_loss(True)
    port_layers.TransformNet.forward = plain_forward
    # fc1 biases before BatchNorm and the gate biases have no gradient in exact
    # arithmetic: their rounding noise is left out of the comparison
    names = [k for k in exact_g if not (k.endswith("bias") and ("fc1" in k or "gate" in k))]

    def as_port(grads):
        named = from_jax_variables(host(grads), host(init.batch_stats), host(init.schedule))
        return {k: v.double().numpy() for k, v in named.items()}

    def worst(grads):
        return max(float(np.abs(grads[k] - exact_g[k]).max()
                         / max(np.abs(exact_g[k]).max(), 1e-30)) for k in names)

    fast_g, two_g = as_port(fast_g), as_port(two_g)
    print(f"first step, loss: float64 {exact:.7f}; port {port:.7f} ({rel(port, exact):.3e}); "
          f"laff_tpu {float(fast):.7f} ({rel(fast, exact):.3e}); laff_tpu with two-pass "
          f"BatchNorm variance {float(two):.7f} ({rel(two, exact):.3e}); port vs laff_tpu "
          f"{rel(port, fast):.3e}")
    print(f"first step, gradients, worst tensor's max |diff| over its largest value against "
          f"float64: port {worst(port_g):.3e}; laff_tpu {worst(fast_g):.3e}; laff_tpu two-pass "
          f"{worst(two_g):.3e}")

    # the two epochs again, the reference on the two-pass variance
    flax.linen.BatchNorm = TwoPassBatchNorm
    jres2 = jt.main(T.JOptions(model_prefix="t2_j2", num_epochs=2, **kw),
                    prepared=T.jax_prepare.prepare(T.JOptions(model_prefix="t2_j2",
                                                              num_epochs=2, **kw)))
    flax.linen.BatchNorm = flax_bn
    for j, p in zip(jres2["history"], pres["history"]):
        print(f"epoch {j['epoch']}, two-pass reference: {j['loss']:.6f} port {p['loss']:.6f} "
              f"rel {rel(p['loss'], j['loss']):.3e}; metrics equal "
              f"{all(j[k] == p[k] for k in pt.METRICS)}")


if __name__ == "__main__":
    main()
