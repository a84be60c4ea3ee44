"""Released GenPose torch checkpoints -> the port's weights (no JAX).

The port's own copy of ``genpose_tpu/utils/torch_port.py`` (numpy only).
The reference releases ``ckpt_epoch{N}.pth`` files holding a
``GFObjectPose`` ``state_dict`` (``networks/posenet_agent.py:117-141``).
``port_gf_state_dict`` maps it onto the flax parameter tree of the JAX
package, checked key by key and shape by shape against a template;
``utils/weights.py::from_jax_variables`` turns that tree into the port's
``state_dict``, and the template comes from the port's own model through
``utils/weights.py::to_jax_variables``.  ``port_state_dict`` composes the
two.

Layout differences handled here:

- torch ``nn.Linear``/1x1-conv weights are ``[out, in]`` / ``[out, in, 1(,1)]``;
  flax ``Dense`` kernels are ``[in, out]`` -> transpose (+ squeeze);
- the reference's fusion tails are single Linears over the concat
  ``[pts_feat, t_feat, pose_feat]`` (``scorenet.py:204``); the flax tree
  splits that kernel into pts / t / pose row blocks (``SplitTail``) and
  ``FusedTails`` banks the tails' blocks side by side;
- torch BatchNorm ``weight/bias`` -> flax ``scale/bias`` params;
  ``running_mean/var`` -> the ``batch_stats`` collection.

Every encoder of ``pts_encoder`` (``pointnet``, ``pointnet2``,
``pointnet_and_pointnet2``), the pooled-feature heads, the per-point heads
(``per_point_feature``) and the EDM decoder head (``PoseDecoderNet``) are
ported.  ``port_checkpoint_file`` writes the port's checkpoint format
(``training/checkpoints.py``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


def _dense(sd: Dict[str, Any], key: str) -> Dict[str, np.ndarray]:
    """torch Linear / 1x1 conv -> flax Dense {kernel, bias}."""
    w = _np(sd[f"{key}.weight"])
    w = w.reshape(w.shape[0], w.shape[1])  # drop trailing 1x(1) conv dims
    out = {"kernel": np.ascontiguousarray(w.T)}
    if f"{key}.bias" in sd:
        out["bias"] = _np(sd[f"{key}.bias"])
    return out


def _bn(sd: Dict[str, Any], key: str) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """torch BatchNorm -> (flax params {scale, bias}, batch_stats {mean, var})."""
    params = {"scale": _np(sd[f"{key}.weight"]), "bias": _np(sd[f"{key}.bias"])}
    stats = {"mean": _np(sd[f"{key}.running_mean"]), "var": _np(sd[f"{key}.running_var"])}
    return params, stats


def _check_like(template, ported, path="") -> None:
    """Raise unless ``ported`` has the template tree's keys and shapes exactly."""
    t_keys, p_keys = set(template.keys()), set(ported.keys())
    if t_keys != p_keys:
        raise ValueError(f"key mismatch at {path or '<root>'}: missing={t_keys - p_keys}, "
                         f"extra={p_keys - t_keys}")
    for k in t_keys:
        t, p = template[k], ported[k]
        if isinstance(t, dict):
            _check_like(t, p, f"{path}/{k}")
        elif tuple(np.shape(t)) != tuple(np.shape(p)):
            raise ValueError(f"shape mismatch at {path}/{k}: template {np.shape(t)} vs "
                             f"ported {np.shape(p)}")


# ---------------------------------------------------------------------------
# heads
# ---------------------------------------------------------------------------

_TAIL_NAMES = {
    "RT": (("tail", "fusion_tail", 512),),
    "R_and_T": (("tail_rot", "fusion_tail_rot", 256),
                ("tail_trans", "fusion_tail_trans", 256)),
    "Rx_Ry_and_T": (("tail_rot_x", "fusion_tail_rot_x", 256),
                    ("tail_rot_y", "fusion_tail_rot_y", 256),
                    ("tail_trans", "fusion_tail_trans", 256)),
}


def port_trunk(sd: Dict[str, Any], prefix: str, regression_head: str = "Rx_Ry_and_T",
               per_point_feature: bool = False,
               pts_feat_dim: int = 1280) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """A PoseScoreNet / PoseEnergyNet slice (torch key prefix ``prefix``,
    e.g. ``"pose_score_net."``) -> the flax ``PoseTrunk`` (params,
    batch_stats).  ``per_point_feature``: the RotHead / TransHead tails
    (``decoder_head/rot_head.py:8-35``), whose conv1 kernel is split into
    [pts, t, pose] row blocks, concat order ``scorenet.py:202``."""
    params: Dict[str, Any] = {
        "t_fourier": {"W": _np(sd[f"{prefix}t_encoder.0.W"])},
        "t_dense": _dense(sd, f"{prefix}t_encoder.1"),
        "pose_dense_0": _dense(sd, f"{prefix}pose_encoder.0"),
        "pose_dense_1": _dense(sd, f"{prefix}pose_encoder.2"),
    }
    specs = _TAIL_NAMES[regression_head]
    if not per_point_feature:
        params.update(_port_tails(sd, prefix, specs))
        return params, {}
    if regression_head != "Rx_Ry_and_T":
        raise NotImplementedError("per_point_feature requires Rx_Ry_and_T")
    stats: Dict[str, Any] = {}
    for flax_name, torch_name, _ in specs:
        base = f"{prefix}{torch_name}"
        w1 = _dense(sd, f"{base}.conv1")["kernel"]  # [f, 1024]
        tail = {"feat_kernel": np.ascontiguousarray(w1[:pts_feat_dim]),
                "t_kernel": np.ascontiguousarray(w1[pts_feat_dim:pts_feat_dim + 128]),
                "pose_kernel": np.ascontiguousarray(w1[pts_feat_dim + 128:]),
                "bias1": _np(sd[f"{base}.conv1.bias"])}
        tail_stats = {}
        for j in (1, 2, 3):
            tail[f"bn{j}"], tail_stats[f"bn{j}"] = _bn(sd, f"{base}.bn{j}")
        for j in (2, 3, 4):
            tail[f"conv{j}"] = _dense(sd, f"{base}.conv{j}")
        params[flax_name], stats[flax_name] = tail, tail_stats
    return params, stats


def _port_tails(sd: Dict[str, Any], prefix: str, specs) -> Dict[str, Any]:
    """The fusion tails of the score / energy trunk and of the EDM decoder
    (identical torch shapes, ``scorenet.py:118-176`` and ``:261-312``): each
    Linear(1024+128+256 -> H) + ReLU + Linear(H -> out), the first kernel's
    rows split into [pts, t-or-sigma, pose] blocks."""
    w1s, b1s, w2s, b2s = [], [], [], []
    for _, torch_name, _ in specs:
        w1s.append(_np(sd[f"{prefix}{torch_name}.0.weight"]).T)  # [1408, H]
        b1s.append(_np(sd[f"{prefix}{torch_name}.0.bias"]))
        w2s.append(_np(sd[f"{prefix}{torch_name}.2.weight"]).T)  # [H, out]
        b2s.append(_np(sd[f"{prefix}{torch_name}.2.bias"]))

    hidden_outs = {(w.shape[1], o.shape[1]) for w, o in zip(w1s, w2s)}
    if len(hidden_outs) == 1:
        w1 = np.concatenate(w1s, axis=1)  # [1408, K*H]
        return {"tails": {
            "feat_kernel": np.ascontiguousarray(w1[:1024]),
            "t_kernel": np.ascontiguousarray(w1[1024:1152]),
            "pose_kernel": np.ascontiguousarray(w1[1152:]),
            "bias": np.concatenate(b1s, axis=0),
            "out_kernel": np.stack(w2s, axis=0),  # [K, H, out]
            "out_bias": np.stack(b2s, axis=0),
        }}
    params: Dict[str, Any] = {}
    for (flax_name, _, _), w1, b1, w2, b2 in zip(specs, w1s, b1s, w2s, b2s):
        params[flax_name] = {
            "feat": {"kernel": np.ascontiguousarray(w1[:1024])},
            "dyn": {"kernel": np.ascontiguousarray(w1[1024:]), "bias": b1},
            "out": {"kernel": w2, "bias": b2},
        }
    return params


def port_decoder(sd: Dict[str, Any], prefix: str,
                 regression_head: str = "Rx_Ry_and_T") -> Dict[str, Any]:
    """A torch ``PoseDecoderNet`` slice (ref ``scorenet.py:225-364``) -> the
    flax decoder's params (no BatchNorm): ``sigma_encoder.1`` (the Dense
    after the parameter-free positional embedding), ``pose_encoder.0/.2``,
    ``fusion_tail*``."""
    params: Dict[str, Any] = {
        "sigma_dense": _dense(sd, f"{prefix}sigma_encoder.1"),
        "pose_dense_0": _dense(sd, f"{prefix}pose_encoder.0"),
        "pose_dense_1": _dense(sd, f"{prefix}pose_encoder.2"),
    }
    params.update(_port_tails(sd, prefix, _TAIL_NAMES[regression_head]))
    return params


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

def port_pointnet2(sd: Dict[str, Any], prefix: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """A torch ``Pointnet2ClsMSG`` slice (``pts_encoder/pointnet2.py:166-211``)
    -> the flax ``Pointnet2ClsMSG`` (params, batch_stats).  torch keys
    ``SA_modules.{k}.mlps.{i}.layer{j}.conv.weight`` (+ ``.layer{j}.bn.bn.*``);
    flax ``sa_{k}/mlp_{i}/dense_{j}`` + ``bn_{j}``."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    k = 0
    while f"{prefix}SA_modules.{k}.mlps.0.layer0.conv.weight" in sd:
        sa_p: Dict[str, Any] = {}
        sa_s: Dict[str, Any] = {}
        i = 0
        while f"{prefix}SA_modules.{k}.mlps.{i}.layer0.conv.weight" in sd:
            mlp_p: Dict[str, Any] = {}
            mlp_s: Dict[str, Any] = {}
            j = 0
            while f"{prefix}SA_modules.{k}.mlps.{i}.layer{j}.conv.weight" in sd:
                base = f"{prefix}SA_modules.{k}.mlps.{i}.layer{j}"
                mlp_p[f"dense_{j}"] = _dense(sd, f"{base}.conv")
                if f"{base}.bn.bn.weight" in sd:
                    mlp_p[f"bn_{j}"], mlp_s[f"bn_{j}"] = _bn(sd, f"{base}.bn.bn")
                j += 1
            sa_p[f"mlp_{i}"] = mlp_p
            if mlp_s:
                sa_s[f"mlp_{i}"] = mlp_s
            i += 1
        params[f"sa_{k}"] = sa_p
        if sa_s:
            stats[f"sa_{k}"] = sa_s
        k += 1
    if not params:
        raise KeyError(f"no SA_modules found under prefix {prefix!r}")
    return params, stats


def port_pointnet(sd: Dict[str, Any], prefix: str) -> Dict[str, Any]:
    """A torch ``PointNetfeat`` slice (``pts_encoder/pointnets.py:83-123``)
    -> the flax ``PointNetfeat`` params (no BatchNorm in either): the
    transformer's ``conv1-3``/``fc1-3`` -> ``stn/Dense_0-5``, the feature
    convs ``conv1-4`` -> ``Dense_0-3``."""
    stn = {f"Dense_{i}": _dense(sd, f"{prefix}stn.{src}")
           for i, src in enumerate(("conv1", "conv2", "conv3", "fc1", "fc2", "fc3"))}
    params: Dict[str, Any] = {"stn": stn}
    for i in range(4):
        params[f"Dense_{i}"] = _dense(sd, f"{prefix}conv{i + 1}")
    return params


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------

def port_gf_state_dict(sd: Dict[str, Any], variables: Dict[str, Any],
                       pts_encoder: str = "pointnet2", regression_head: str = "Rx_Ry_and_T",
                       per_point_feature: bool = False, pts_feat_dim: int = 1280,
                       decoder_head: bool = False) -> Dict[str, Any]:
    """A full torch ``GFObjectPose`` state_dict -> ``{"params", "batch_stats"}``
    in the flax layout of the template ``variables`` (same structure as
    ``genpose_tpu/utils/torch_port.py::port_gf_state_dict``).  Score and
    energy models alike (the reference names the head ``pose_score_net`` in
    both modes, ``posenet.py:59-67``); the encoders under the reference's
    names (``pts_encoder``, or ``pts_pointnet_encoder``,
    ``pts_pointnet2_encoder`` and ``fusion_layer``); ``per_point_feature``
    for per-point heads, ``decoder_head`` for an EDM score model.  Raises
    on a missing key (KeyError) or on any key or shape that differs from
    the template (ValueError)."""
    sd = {k: _np(v) for k, v in sd.items() if not k.endswith("num_batches_tracked")}
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    if pts_encoder == "pointnet2":
        params["encoder"], stats["encoder"] = port_pointnet2(sd, "pts_encoder.")
    elif pts_encoder == "pointnet":
        params["encoder"] = port_pointnet(sd, "pts_encoder.")
    elif pts_encoder == "pointnet_and_pointnet2":
        params["encoder_pn"] = port_pointnet(sd, "pts_pointnet_encoder.")
        params["encoder_pn2"], stats["encoder_pn2"] = port_pointnet2(sd, "pts_pointnet2_encoder.")
        params["fusion_layer"] = _dense(sd, "fusion_layer")
    else:
        raise NotImplementedError(pts_encoder)
    if decoder_head:
        params["head"] = port_decoder(sd, "pose_score_net.", regression_head=regression_head)
    else:
        trunk_p, trunk_s = port_trunk(sd, "pose_score_net.", regression_head=regression_head,
                                      per_point_feature=per_point_feature,
                                      pts_feat_dim=pts_feat_dim)
        params["head"] = {"trunk": trunk_p}
        if trunk_s:
            stats["head"] = {"trunk": trunk_s}
    _check_like(variables["params"], params)
    template_stats = variables.get("batch_stats", {})
    if template_stats:
        _check_like(template_stats, stats)
    out = {"params": params}
    if template_stats:
        out["batch_stats"] = stats
    return out


def port_state_dict(sd: Dict[str, Any], model, regression_head: str = "Rx_Ry_and_T",
                    per_point_feature: bool = False, pts_feat_dim: int = 1280):
    """An upstream ``GFObjectPose`` state_dict -> the port's ``state_dict`` for
    ``model`` (a port ``GFObjectPose``, which is the template; with
    ``per_point_feature``, one whose head is a per-point ``PoseScoreNet``):
    ``from_jax_variables(port_gf_state_dict(...))``."""
    from genpose_tpu_torch.utils.weights import from_jax_variables, to_jax_variables

    params, stats = to_jax_variables(model)
    variables = port_gf_state_dict(sd, {"params": params, "batch_stats": stats},
                                   pts_encoder=model.pts_encoder,
                                   regression_head=regression_head,
                                   per_point_feature=per_point_feature,
                                   pts_feat_dim=pts_feat_dim,
                                   decoder_head=model.decoder_head)
    return from_jax_variables(variables["params"], variables.get("batch_stats", {}))


def port_checkpoint_file(input_path: str, output_dir: str, cfg, posenet_mode: str = "score",
                         epoch: Optional[int] = None) -> str:
    """Convert a reference ``.pth`` checkpoint into the port's checkpoint
    format, ``<output_dir>/ckpt_epoch{N}`` (+ ``clock.json`` when the file
    has a clock), loadable by ``training/checkpoints.py::load_checkpoint``.

    The reference saves the EMA-swapped weights as the model weights
    (``posenet_agent.py:124-126``), so the ported params fill both the live
    params and the EMA shadow.  ``epoch`` defaults to the clock's.  Runs on
    the CPU.  Returns the written checkpoint path."""
    from genpose_tpu_torch.training.agent import PoseAgent
    from genpose_tpu_torch.training.checkpoints import save_checkpoint
    from genpose_tpu_torch.training.state import EMA

    sd, clock = load_torch_checkpoint(input_path)
    agent = PoseAgent(cfg, posenet_mode, device="cpu")
    agent.model.load_state_dict(port_state_dict(sd, agent.model, cfg.regression_head))
    shadow = {k: p.detach().clone() for k, p in agent.params().items()}
    agent.state.ema = EMA(agent.state.ema.decay, shadow)
    if epoch is None:
        epoch = int(clock["epoch"]) if clock and "epoch" in clock else 0
    return save_checkpoint(output_dir, agent, epoch, clock=clock)


def load_torch_checkpoint(path: str) -> Tuple[Dict[str, np.ndarray], Optional[dict]]:
    """Read a reference ``.pth`` checkpoint -> (numpy state_dict, clock).
    Accepts the training checkpoint dict (``{'clock', 'model_state_dict',
    ...}``, ``posenet_agent.py:131-136``) and a bare state_dict.  The file
    is unpickled in full, as the JAX package's porter reads it: convert only
    files from a trusted source."""
    import torch

    blob = torch.load(path, map_location="cpu", weights_only=False)
    clock = None
    if isinstance(blob, dict) and "model_state_dict" in blob:
        clock = blob.get("clock")
        blob = blob["model_state_dict"]
    return {k: _np(v) for k, v in blob.items()}, clock
