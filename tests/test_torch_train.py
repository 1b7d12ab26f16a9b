"""The port's training step and loop (``deconv_api_tpu_torch/train``)
against the JAX package's on the CPU, on the same numpy batches and params.

Models: ``vgg_tiny`` (32x32, 100 classes) and MobileNet v1 at 64x64 with 10
classes (``tests/torch_dag_families.py``), whose BatchNorm leaves train as
ordinary weights.  Bars (of the largest magnitude where not said):
- the logits (``logits=True``): 1e-5;
- one step's loss against ``jax.value_and_grad`` of the JAX step's loss:
  1e-5 relative; every gradient leaf: 1e-4 of the leaf's largest;
- the port's AdamW given JAX's gradients against ``optax.adamw(lr)``:
  1e-6 relative, over three updates;
- three steps, each in lockstep from the JAX step's state: the loss 1e-5
  relative, both moments 1e-4 of each leaf's largest, the count and step
  equal; the params per element (``_params_match``): within 2 lr where the
  step's gradient lies within the gradient bar of 0 (1e-4 of the leaf's
  largest, where the two packages may round it to other signs and Adam
  moves the element by about lr sign(g) either way), elsewhere within 1e-2
  of the leaf's largest change.  The whole run: each step's loss 1e-5
  relative, the params as in lockstep with the step-0 gradient choosing the
  elements held to 2 lr a step; for MobileNet v1 the other elements are
  held leaf by leaf (RMS) instead, see ``test_three_steps_match_the_jax_step``;
- ``remat`` on and off: equal;
- ``train_synthetic`` of both packages, each package's batch source
  patched to the same numpy batches: the same keys and settings, the
  losses 1e-5 relative, the accuracies equal, the params as in the whole
  run above.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deconv_api_tpu.models import apply as j_apply
from deconv_api_tpu.models.spec import init_params as j_init_params
from deconv_api_tpu.models.tiny import VGG_TINY_SPEC as J_TINY_SPEC
from deconv_api_tpu.parallel.mesh import make_mesh
from deconv_api_tpu.train import loop as j_loop
from deconv_api_tpu.train import step as j_step
from deconv_api_tpu_torch.models import VGG_TINY_SPEC, init_params
from deconv_api_tpu_torch.models.apply import forward, spec_forward
from deconv_api_tpu_torch.models.weights import flat_arrays, params_from_jax, tree_map
from deconv_api_tpu_torch.train import loop, step
from tests.torch_dag_families import FAMILIES, numpy_params

DAG = "mobilenet_v1"
LR = 1e-4  # both packages' default
STEPS = 3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _flat(tree, prefix=""):
    """Any nested dict of arrays or tensors as ``{"a/b/leaf": np.ndarray}``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    return out


def _nest(flat: dict) -> dict:
    out: dict = {}
    for key, v in flat.items():
        *parents, leaf = key.split("/")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


@functools.cache
def _case(name: str, direction: str = "jax_to_port"):
    """``(numpy params, port model, JAX apply_fn(params, x) -> logits,
    port forward_fn or None, input size, classes)``.  ``jax_to_port`` starts
    from the JAX init's tree (its shapes, He-normal from numpy: the JAX
    init itself takes seconds on the CPU), given to the port through
    ``params_from_jax``; ``port_to_jax`` from the port's init (its tensors
    to numpy, into JAX)."""
    if name == "vgg_tiny":
        if direction == "jax_to_port":
            rng = np.random.default_rng(3)
            shapes = {"/".join(k.key for k in path): s for path, s in jax.tree_util.tree_flatten_with_path(
                jax.eval_shape(functools.partial(j_init_params, J_TINY_SPEC), jax.random.PRNGKey(3)))[0]}
            tree = {k: (rng.standard_normal(s.shape) * np.sqrt(2.0 / np.prod(s.shape[:-1]))).astype(np.float32)
                    if k.endswith("/w") else rng.normal(0.0, 0.05, s.shape).astype(np.float32)
                    for k, s in shapes.items()}
        else:
            tree = _flat(init_params(VGG_TINY_SPEC, torch.Generator().manual_seed(3)))
        return (_nest(tree), VGG_TINY_SPEC, lambda p, x: j_apply.forward(J_TINY_SPEC, p, x, logits=True), None,
                32, VGG_TINY_SPEC.layers[-1].filters)
    _, jfwd, _, fwd, size = FAMILIES[name]
    return (numpy_params(name), lambda p, x: fwd(p, x, logits=True)[0],
            lambda p, x: jfwd(p, x, logits=True)[0], fwd, size, 10)


def _batches(size: int, classes: int, n: int = STEPS, b: int = 4, seed: int = 5):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((b, size, size, 3)).astype(np.float32),
             rng.integers(0, classes, b).astype(np.int32)) for _ in range(n)]


def _jax_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _mesh():
    return make_mesh((1, 1), axis_names=("dp", "tp"), devices=jax.devices()[:1])


@functools.cache
def _jax_loss_grad(name: str):
    _, _, japply, *_ = _case(name)

    def loss_fn(p, x, y):
        return optax.softmax_cross_entropy_with_integer_labels(japply(p, x), y).mean()

    return jax.jit(jax.value_and_grad(loss_fn))


def _close(got, want, bar, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    assert err <= bar * max(np.abs(want).max(), 1e-30), f"{what}: {err} > {bar} of {np.abs(want).max()}"


# ------------------------------------------------------------------ logits


@pytest.mark.parametrize("name", ["vgg_tiny", DAG])
def test_logits_match_jax(name):
    """``logits=True`` skips the softmax and nothing else: the logits, the
    recorded ``predictions`` and the softmax of the default forward."""
    tree, _, japply, fwd, size, _ = _case(name)
    x = _batches(size, 10, n=1)[0][0]
    want = np.asarray(jax.jit(japply)(_jax_tree(tree), jnp.asarray(x)))
    params = params_from_jax(tree)
    if fwd is None:
        got, acts = spec_forward(VGG_TINY_SPEC, logits=True)(params, torch.from_numpy(x))
        probs = forward(VGG_TINY_SPEC, params, torch.from_numpy(x))
    else:
        got, acts = fwd(params, torch.from_numpy(x), logits=True)
        probs, _ = fwd(params, torch.from_numpy(x))
    _close(got.numpy(), want, 1e-5, "logits")
    assert torch.equal(acts["predictions"], got)
    _close(probs.numpy(), np.asarray(jax.nn.softmax(want, axis=-1)), 1e-5, "softmax")


# ------------------------------------------------------------ one step


@pytest.mark.parametrize("name", ["vgg_tiny", DAG])
def test_one_step_loss_and_gradients_match_jax(name):
    """The port's loss and every gradient leaf (BatchNorm's too) on the
    JAX step's loss (softmax cross-entropy, integer labels, mean)."""
    tree, model, *_rest = _case(name)
    size, classes = _rest[-2], _rest[-1]
    x, y = _batches(size, classes, n=1)[0]
    jloss, jgrads = _jax_loss_grad(name)(_jax_tree(tree), jnp.asarray(x), jnp.asarray(y))
    init_fn, step_fn = step.make_train_step(model, "cpu", LR)
    state = init_fn(params_from_jax(tree))
    ws = step.leaves(state.params)
    loss = torch.nn.functional.cross_entropy(step._as_apply_fn(model)(state.params, torch.from_numpy(x)),
                                             torch.from_numpy(y).long())
    grads = torch.autograd.grad(loss, ws)
    assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    jflat = _flat(jgrads)
    names = list(_flat(state.params))
    assert sorted(names) == sorted(jflat), "the two trees' leaves differ"
    for key, g in zip(names, grads):
        _close(g.numpy(), jflat[key], 1e-4, key)
    # the step itself returns this loss
    _, step_loss = step_fn(state, torch.from_numpy(x), torch.from_numpy(y).long())
    assert step_loss.item() == loss.item()


def test_adamw_matches_optax_given_jax_gradients():
    """Three updates of the port's AdamW (weight decay 1e-4 on every leaf,
    biases included) fed JAX's gradients, against ``optax.adamw(lr)``."""
    tree, model, *_rest = _case("vgg_tiny")
    opt, apply = _adamw_apply()
    jparams = _jax_tree(tree)
    jstate = opt.init(jparams)
    init_fn, _ = step.make_train_step(model, "cpu", LR)
    state = init_fn(params_from_jax(tree))
    x, y = _batches(32, 100, n=1)[0]
    for i in range(STEPS):
        _, jgrads = _jax_loss_grad("vgg_tiny")(jparams, jnp.asarray(x), jnp.asarray(y))
        grads = _flat(jgrads)
        jparams, jstate = apply(jgrads, jstate, jparams)
        opt_state = step.adamw(state.params, [torch.from_numpy(grads[k].copy()) for k in _flat(state.params)],
                               state.opt_state, LR)
        state = state._replace(opt_state=opt_state)
    assert state.opt_state.count == int(jstate[0].count)
    want = _flat(jparams)
    for key, got in _flat(state.params).items():
        _close(got, want[key], 1e-6, key)
    for moment in ("mu", "nu"):
        want = _flat(getattr(jstate[0], moment))
        for key, got in _flat(getattr(state.opt_state, moment)).items():
            _close(got, want[key], 1e-6, f"{moment}/{key}")


@functools.cache
def _adamw_apply():
    """``optax.adamw(LR)``'s update and ``apply_updates``, jitted."""
    opt = optax.adamw(LR)

    def apply(grads, opt_state, params):
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    return opt, jax.jit(apply)


@functools.cache
def _jax_step(name: str):
    """``(init_jit, step_jit)`` of the JAX step for ``name``'s tree (both
    directions share its shapes), built once."""
    tree, _, japply, *_ = _case(name)
    if name == "vgg_tiny":
        return j_step.make_train_step(japply, _mesh(), optax.adamw(LR))(_jax_tree(tree))
    (opt, apply), value_and_grad = _adamw_apply(), _jax_loss_grad(name)

    def init_jit(params):
        return j_step.TrainState(params, opt.init(params), jnp.zeros((), jnp.int32))

    def step_jit(state, x, y):
        loss, grads = value_and_grad(state.params, x, y)
        params, opt_state = apply(grads, state.opt_state, state.params)
        return j_step.TrainState(params, opt_state, state.step + 1), loss

    return init_jit, step_jit


def _jax_states(name: str, tree, batches):
    """The JAX package's step (``make_train_step`` on a one-device mesh,
    ``optax.adamw(LR)``) over ``batches``: its host TrainState before each
    step and after the last, and each step's loss.  For the DAG family the
    same step is composed from the loss's jitted ``value_and_grad`` (shared
    with the one-step test) and ``optax.adamw(LR)``, without
    ``jax.checkpoint``, which changes no value: compiling the whole step
    again would cost some 13 s on one core."""
    init_jit, step_jit = _jax_step(name)
    state = init_jit(_jax_tree(tree))
    states, losses = [jax.device_get(state)], []
    for x, y in batches:
        state, loss = step_jit(state, jnp.asarray(x), jnp.asarray(y))
        states.append(jax.device_get(state))
        losses.append(float(loss))
    return states, losses


def _port_state(jstate) -> step.TrainState:
    """A JAX TrainState (host arrays) as the port's, on the CPU."""
    adam = jstate.opt_state[0]
    return step.TrainState(params_from_jax(jstate.params),
                           step.AdamWState(int(adam.count), params_from_jax(adam.mu), params_from_jax(adam.nu)),
                           int(jstate.step))


def _port_train(model, tree, batches, remat=True):
    init_fn, step_fn = step.make_train_step(model, "cpu", LR, remat=remat)
    state = init_fn(params_from_jax(tree))
    losses = []
    for x, y in batches:
        state, loss = step_fn(state, torch.from_numpy(x), torch.from_numpy(y).long())
        losses.append(float(loss))
    return _flat(state.params), losses, state


GRAD_BAR = 1e-4  # of a gradient leaf's largest magnitude, as in the one-step test
PARAM_BAR = 1e-2  # of a param leaf's largest change, away from the gradient bar


def _params_match(got: dict, want: dict, start: dict, grads: dict, steps: int, *, per_element: bool = True) -> None:
    """``got`` against ``want`` after ``steps`` steps from ``start``.

    Adam moves each element about lr sign(its moment) a step whatever the
    gradient's size, so an element whose ``grads`` (JAX's, before the
    first of the steps) lies within ``GRAD_BAR`` of 0 may part by up to
    2 lr a step: its sign is rounding noise.  Every other element is held
    within ``PARAM_BAR`` of the leaf's largest change, or with
    ``per_element=False`` the leaf's RMS difference over those elements
    within ``PARAM_BAR`` of their RMS change (each still within 2 lr a
    step)."""
    for key, w in want.items():
        w = w.astype(np.float64)
        err, change = np.abs(got[key].astype(np.float64) - w), np.abs(w - start[key])
        g = np.abs(grads[key])
        noise = g <= GRAD_BAR * g.max()
        assert err.max() <= 2 * LR * steps, f"{key}: {err.max()} > {2 * LR * steps}"
        if noise.all():
            continue
        if per_element:
            assert err[~noise].max() <= PARAM_BAR * change.max(), \
                f"{key}: {err[~noise].max()} > {PARAM_BAR} of {change.max()}"
        else:
            rms, rms_change = np.sqrt((err[~noise] ** 2).mean()), np.sqrt((change[~noise] ** 2).mean())
            assert rms <= PARAM_BAR * rms_change, f"{key}: RMS {rms} > {PARAM_BAR} of {rms_change}"


def _grads(name: str, params, batch) -> dict:
    """JAX's gradient of ``name``'s loss at ``params`` on ``batch``, flat."""
    x, y = batch
    return _flat(_jax_loss_grad(name)(_jax_tree(params), jnp.asarray(x), jnp.asarray(y))[1])


@pytest.mark.parametrize("name,direction", [("vgg_tiny", "jax_to_port"), ("vgg_tiny", "port_to_jax"),
                                            (DAG, "jax_to_port")])
def test_three_steps_match_the_jax_step(name, direction):
    """Three steps of the port's ``step_fn`` against the JAX package's step
    on the same batches, from the JAX init (``params_from_jax``) and from
    the port's init (its tensors as numpy into JAX).

    In lockstep, from the JAX state before each step (params, moments,
    count): the loss within 1e-5 relative, the count and step equal, both
    moments within 1e-4 of each leaf's largest (the gradients' bar: a
    moment is linear in the gradient), the params as ``_params_match`` says
    with that step's JAX gradient.  Over the whole run: each step's loss
    within 1e-5 relative, the params as ``_params_match`` says with the
    first step's gradient.  For MobileNet v1 the run's elements are held
    leaf by leaf: an element flipped at one step moves its neighbours'
    later gradients by more than rounding, and with it elements whose
    gradients are small but above the bar (measured: up to 0.12 of a leaf's
    change per element, at most 2.4e-3 of it in RMS)."""
    tree, model, *_rest = _case(name, direction)
    size, classes = _rest[-2], _rest[-1]
    batches = _batches(size, classes)
    states, jlosses = _jax_states(name, tree, batches)
    _, step_fn = step.make_train_step(model, "cpu", LR)
    for k, (x, y) in enumerate(batches):
        got, loss = step_fn(_port_state(states[k]), torch.from_numpy(x), torch.from_numpy(y).long())
        want = states[k + 1]
        assert abs(loss.item() - jlosses[k]) <= 1e-5 * abs(jlosses[k]), k
        assert (got.step, got.opt_state.count) == (int(want.step), int(want.opt_state[0].count)) == (k + 1, k + 1)
        for moment in ("mu", "nu"):
            wm = _flat(getattr(want.opt_state[0], moment))
            for key, m in _flat(getattr(got.opt_state, moment)).items():
                _close(m, wm[key], 1e-4, f"step {k} {moment}/{key}")
        _params_match(_flat(got.params), _flat(want.params), _flat(states[k].params),
                      _grads(name, states[k].params, (x, y)), 1)
    params, losses, _ = _port_train(model, tree, batches)
    for k, (a, b) in enumerate(zip(losses, jlosses)):
        assert abs(a - b) <= 1e-5 * abs(b), k
    _params_match(params, _flat(states[-1].params), _flat(states[0].params), _grads(name, tree, batches[0]), STEPS,
                  per_element=name == "vgg_tiny")


def test_remat_on_and_off_give_equal_params():
    tree, model, *_rest = _case("vgg_tiny")
    batches = _batches(_rest[-2], _rest[-1])
    on, losses_on, _ = _port_train(model, tree, batches, remat=True)
    off, losses_off, _ = _port_train(model, tree, batches, remat=False)
    assert losses_on == losses_off
    for key in on:
        np.testing.assert_array_equal(on[key], off[key], err_msg=key)


# ----------------------------------------------------------- the loop


def test_train_synthetic_matches_the_jax_loop(monkeypatch):
    """Both packages' ``train_synthetic`` on vgg_tiny, their batch sources
    patched to hand out the same numpy batches in call order (the held-out
    set first, then one batch a step): the summary's keys, losses,
    accuracies and final params."""
    tree, *_ = _case("vgg_tiny")
    steps, batch = 3, 8
    held_out = _batches(32, 100, n=1, b=128, seed=11)
    stream = held_out + _batches(32, 100, n=steps, b=batch, seed=12)

    def source(to_array):
        calls = iter(stream)

        def fake(_gen, b, shape, classes):
            x, y = next(calls)
            assert (b, *shape) == x.shape and classes == 100
            return to_array(x, y)

        return fake

    monkeypatch.setattr(j_loop, "_synthetic_batch", source(lambda x, y: (jnp.asarray(x), jnp.asarray(y))))
    monkeypatch.setattr(loop, "_synthetic_batch",
                        source(lambda x, y: (torch.from_numpy(x), torch.from_numpy(y).long())))
    common = dict(steps=steps, batch=batch, lr=LR, mesh_shape=(1,), seed=0)
    want = j_loop.train_synthetic(J_TINY_SPEC, _jax_tree(tree), **common)
    got = loop.train_synthetic(VGG_TINY_SPEC, params_from_jax(tree), device="cpu", **common)
    assert sorted(got) == sorted(want)
    assert {k: got[k] for k in ("model", "steps", "batch", "mesh", "resumed_from", "checkpoint")} == \
        {k: want[k] for k in ("model", "steps", "batch", "mesh", "resumed_from", "checkpoint")}
    for k in ("final_loss", "eval_loss_initial", "eval_loss"):
        assert abs(got[k] - want[k]) <= 1e-5 * abs(want[k]), k
    for k in ("eval_accuracy_initial", "eval_accuracy"):
        assert got[k] == want[k], k
    _params_match(flat_arrays(got["params"]), _flat(want["params"]), _flat(tree), _grads("vgg_tiny", tree, stream[1]),
                  steps)
    assert tree_map(lambda t: t.dtype, got["params"])["fc1"]["w"] == torch.float32
