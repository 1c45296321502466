"""YAML configs with ``target:``/``params:`` instantiation, for the ported models.

Counterpart of the ``latent_diffusion``, ``unet``, ``vq_model``,
``vq_model_interface``, ``vq_loss``, ``layout_unet``, ``layout_encoder``,
``unet1d``, ``layout_diffusion``, ``cube_ae``, ``cube_latent_diffusion``,
``vq_model_gaus``, ``ptv3``, ``dense_decoder``, ``gs_decoder_head`` and
``ptv3_segmentor``, ``r2dm_diffusion``, ``efficient_unet``,
``vq_model_object``, ``vq_loss_1d``, ``autoencoder_kl`` and ``identity``
builders of ``lidar_layout_tpu/config.py`` (with the reference's
target-name aliases), of its conditioning stages
(``class_embedder``, ``spatial_rescaler``, ``bert_embedder`` with either
backend, ``transformer_embedder``, ``clip_text``, ``clip_multi_text``,
``clip_multi_image``), of the point-backbone zoo (``ptv2``,
``ptv1_seg26``/``38``/``50``, ``spunet``, ``stratified``, ``octformer``,
``swin3d``: each takes the keys its config dataclass has and drops the
rest, as JAX's) and of its ``load_yaml`` and ``apply_dotlist``. Targets
not ported yet raise KeyError.

The point models (``ptv3``, ``dense_decoder``, ``ptv3_segmentor``) take
the width of their input features as ``in_features`` when the caller
gives it (the width of the data's ``feats``), as JAX's flax modules infer it
at ``init`` from the first batch: ``gaus_10cm.yaml`` says ``in_channels:
3`` and its clouds carry 4.

``r2dm_diffusion`` reads what JAX's ``build_r2dm`` reads: ``image_size``,
``channels``, ``timesteps`` and, of the U-Net block, ``base_channels``,
``channel_multiplier`` and the first of ``num_residual_blocks``; the cosine
schedule and the Fourier encoding are the config's defaults whatever the
YAML's ``linear_start``, ``linear_end``, ``attn_num_heads``,
``coords_encoding``, ``ring`` or ``lidar_utils_config`` say.
``vq_model_object`` reads ``num_points``, ``modelconfig.params.num_grids``,
``embed_dim`` and ``n_embed`` (the quantizer stays off).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from .encoders import modules as E
from .encoders.layout_encoder import LayoutEncoderConfig, LayoutTransformerEncoder
from .losses.vq_loss import VQLossConfig
from .models.autoencoder import AEConfig, AutoencoderKL, VQModel, VQModelInterface
from .models.autoencoder_gaus import VQModelGaus
from .models.cube_diffusion import CubeDiffusion, CubeDiffusionConfig, SparseUNetConfig
from .models.diffusion import DiffusionConfig, LatentDiffusion
from .models.gs_decoder import DenseDecoder, GSDecoderConfig
from .models.layout_diffusion import LayoutDiffusion, LayoutDiffusionConfig
from .models.object_ae import ObjectAEConfig, VQModelObject
from .models.object_cross_unet import LayoutDiffusionUNetModel, LayoutUNetConfig
from .models.octformer import OctFormer, OctFormerConfig
from .models.ptv1 import PointTransformerSeg, PTv1Config
from .models.ptv2 import PointTransformerV2, PTv2Config
from .models.ptv3 import PTv3, PTv3Config, PTv3Segmentor
from .models.r2dm import R2DMConfig, R2DMDiffusion
from .models.sparse_vae import SparseVAE, SparseVAEConfig
from .models.spunet import SpUNet, SpUNetConfig
from .models.stratified import StratifiedConfig, StratifiedTransformer
from .models.swin3d import Swin3DConfig, Swin3DUNet
from .models.unet import UNetConfig, UNetModel
from .models.unet1d import UNet1DConfig

UNET_TARGETS = ("unet", "lidm.modules.diffusion.openaimodel.UNetModel")
LAYOUT_UNET_TARGETS = ("layout_unet",
                       "lidm.modules.unets.object_cross_unet.LayoutDiffusionUNetModel")
LAYOUT_ENCODER_TARGETS = ("layout_encoder",
                          "lidm.modules.encoders.layout_encoder.LayoutTransformerEncoder")
CUBE_AE_TARGETS = ("cube_ae", "lidm.models.ae.autoencoder_cube.CubeAEModel",
                   "lidm.models.ae.autoencoder_cube.CubeModelInterface")
CUBE_LDM_TARGETS = ("cube_latent_diffusion",
                    "lidm.models.diffusion.ddpm_cube.CubeLatentDiffusion")
GAUS_AE_TARGETS = ("vq_model_gaus", "lidm.models.ae.autoencoder_gaus.VQModel_Gaus")
R2DM_TARGETS = ("r2dm_diffusion", "lidm.models.diffusion.ddpm_r2dm.R2DMDiffusion")
OBJECT_AE_TARGETS = ("vq_model_object", "lidm.models.ae.autoencoder_object.VQModel_Object")
KL_AE_TARGETS = ("autoencoder_kl", "lidm.models.autoencoder.AutoencoderKL",
                 "lidm.models.ae.autoencoder.AutoencoderKL")


def _ae_cfg(dd: Dict[str, Any]) -> AEConfig:
    return AEConfig(
        ch=dd.get("ch", 64), out_ch=dd.get("out_ch", 1),
        ch_mult=tuple(dd.get("ch_mult", (1, 2, 2, 4))),
        strides=tuple(tuple(s) for s in dd.get("strides", ((1, 2), (2, 2), (2, 2)))),
        num_res_blocks=dd.get("num_res_blocks", 2),
        attn_levels=tuple(dd.get("attn_levels", ())),
        dropout=dd.get("dropout", 0.0),
        in_channels=dd.get("in_channels", 1),
        z_channels=dd.get("z_channels", 8),
        double_z=dd.get("double_z", False),
        # the reference's Encoder and Decoder take ddconfig's attn_type; the
        # JAX package's builder drops it (ROADMAP section 3)
        attn_type=dd.get("attn_type", "vanilla"))


def build_unet_cfg(params: Dict[str, Any]) -> UNetConfig:
    return UNetConfig(
        in_channels=params["in_channels"],
        model_channels=params["model_channels"],
        out_channels=params["out_channels"],
        num_res_blocks=params["num_res_blocks"],
        attention_resolutions=tuple(params.get("attention_resolutions", ())),
        channel_mult=tuple(params.get("channel_mult", (1, 2, 4))),
        dropout=params.get("dropout", 0.0),
        num_heads=params.get("num_heads", -1),
        num_head_channels=params.get("num_head_channels", -1),
        use_spatial_transformer=params.get("use_spatial_transformer", False),
        transformer_depth=params.get("transformer_depth", 1),
        context_dim=params.get("context_dim"),
        num_classes=params.get("num_classes"),
        cconv=params.get("lib_name", "lidm") in ("lidm", "lidm_v0"))


def build_layout_unet_cfg(params: Dict[str, Any]) -> LayoutUNetConfig:
    """As the JAX package's: ``resblock_updown`` is not read (the layout
    U-Net resamples with convs)."""
    return LayoutUNetConfig(
        in_channels=params.get("in_channels", 8),
        model_channels=params.get("model_channels", 256),
        out_channels=params.get("out_channels", 8),
        num_res_blocks=params.get("num_res_blocks", 2),
        channel_mult=tuple(params.get("channel_mult", (1, 2, 4))),
        attention_ds=tuple(params.get("attention_ds", (1, 2, 4))),
        encoder_channels=params.get("encoder_channels", 256),
        num_head_channels=params.get("num_head_channels", 64),
        dropout=params.get("dropout", 0.1),
        use_scale_shift_norm=params.get("use_scale_shift_norm", True),
        image_size=tuple(params.get("image_size", (8, 128))),
        cconv=params.get("lib_name", "lidm") in ("lidm", "lidm_v0"))


def build_layout_encoder_cfg(params: Dict[str, Any]) -> LayoutEncoderConfig:
    return LayoutEncoderConfig(
        layout_length=params.get("layout_length", 13),
        hidden_dim=params.get("hidden_dim", 256),
        output_dim=params.get("output_dim", 1024),
        num_layers=params.get("num_layers", 6),
        num_heads=params.get("num_heads", 8),
        num_classes=params.get("num_classes_for_layout_object", 9),
        use_final_ln=params.get("use_final_ln", True),
        use_positional_embedding=params.get("use_positional_embedding", False),
        feature_map_size=tuple(params.get("feature_map_size", (8, 128))),
        resolution_to_attention=tuple(params.get("resolution_to_attention", (8, 4, 2))))


def build_unet1d_cfg(params: Dict[str, Any]) -> UNet1DConfig:
    """As the JAX package's: the GCN head keeps its defaults (``gconv_dim``
    64, 16 predicates)."""
    return UNet1DConfig(
        in_channels=params.get("in_channels", 8),
        model_channels=params.get("model_channels", 512),
        out_channels=params.get("out_channels", 8),
        num_res_blocks=params.get("num_res_blocks", 2),
        attention_resolutions=tuple(params.get("attention_resolutions", (4, 2))),
        channel_mult=tuple(params.get("channel_mult", (1, 1, 1, 1))),
        num_heads=params.get("num_heads", 8),
        transformer_depth=params.get("transformer_depth", 1),
        conditioning_key=params.get("conditioning_key", "crossattn"),
        concat_dim=params.get("concat_dim", 1280),
        crossattn_dim=params.get("crossattn_dim", 1280),
        enable_t_emb=params.get("enable_t_emb", True),
        dropout=params.get("dropout", 0.0))


def _build_layout_diffusion(params: Dict[str, Any], **_) -> LayoutDiffusion:
    """``vocab`` ({num_objs, num_preds}) is injected into ``params`` by the
    caller, as ``scripts/train_layout.py`` does from its dataset; 32 and 16
    without it."""
    csc = params.get("cond_stage_config", {}) or {}
    csp = csc.get("params", {}) if isinstance(csc, dict) else {}
    vocab = params.get("vocab", {})
    return LayoutDiffusion(
        LayoutDiffusionConfig(
            timesteps=params.get("timesteps", 1000),
            linear_start=params.get("linear_start", 1e-4),
            linear_end=params.get("linear_end", 2e-2),
            loss_type=params.get("loss_type", "l2"),
            parameterization=params.get("parameterization", "eps")),
        build_unet1d_cfg(params["unet_config"]["params"]),
        num_objs=vocab.get("num_objs", 32), num_preds=vocab.get("num_preds", 16),
        sg_embedding_dim=csp.get("embedding_dim", 64), use_clip=csp.get("use_clip", True))


def _build_vq(params: Dict[str, Any], interface: bool = False, gaus: bool = False) -> VQModel:
    cls = VQModelGaus if gaus else VQModelInterface if interface else VQModel
    return cls(_ae_cfg(params["ddconfig"]), n_embed=params.get("n_embed", 16384),
               embed_dim=params.get("embed_dim", 8), use_mask=params.get("use_mask", False))


def _build_vq_loss(params: Dict[str, Any], **_) -> VQLossConfig:
    """As the JAX package's ``build_vq_loss``: ``disc_version``,
    ``disc_num_layers``, ``disc_in_channels``, ``disc_factor`` and
    ``pixelloss_weight`` are not read (ROADMAP section 3)."""
    return VQLossConfig(
        codebook_weight=params.get("codebook_weight", 1.0),
        pixel_loss=params.get("pixel_loss", "l1"),
        mask_factor=params.get("mask_factor", 0.0),
        geo_factor=params.get("geo_factor", 1.0),
        perceptual_factor=params.get("perceptual_factor", 0.0),
        smooth_factor=params.get("smooth_factor", 0.1),
        norm_factor=params.get("norm_factor", 0.1),
        disc_start=params.get("disc_start", 1),
        disc_weight=params.get("disc_weight", 1.0),
        disc_loss=params.get("disc_loss", "hinge"),
        curve_length=params.get("curve_length", 4))


def _build_unet(params: Dict[str, Any], **_) -> UNetModel:
    return UNetModel(build_unet_cfg(params))


def _build_latent_diffusion(params: Dict[str, Any],
                            dtype: torch.dtype = torch.float32) -> LatentDiffusion:
    image_size = params.get("image_size", [16, 128])
    diff_cfg = DiffusionConfig(
        timesteps=params.get("timesteps", 1000),
        beta_schedule=params.get("beta_schedule", "linear"),
        linear_start=params.get("linear_start", 1e-4),
        linear_end=params.get("linear_end", 2e-2),
        parameterization=params.get("parameterization", "eps"),
        loss_type=params.get("loss_type", "l2"),
        conditioning_key=params.get("conditioning_key"),
        scale_factor=params.get("scale_factor", 1.0),
        scale_by_std=params.get("scale_by_std", False),
        cond_stage_trainable=params.get("cond_stage_trainable", False),
        learn_logvar=params.get("learn_logvar", False),
        latent_shape=(image_size[0], image_size[1], params.get("channels", 8)))
    unet_target = params["unet_config"].get("target", "")
    unet_cfg, unet = None, None
    if unet_target in LAYOUT_UNET_TARGETS:
        unet = instantiate_from_config(params["unet_config"])
    elif unet_target in UNET_TARGETS:
        unet_cfg = build_unet_cfg(params["unet_config"]["params"])
    else:
        raise NotImplementedError(f"U-Net target {unet_target!r} is not ported yet "
                                  f"(ROADMAP queue 1)")
    cond_stage = None
    csc = params.get("cond_stage_config")
    if isinstance(csc, dict):
        cond_stage = instantiate_from_config(csc)
    fs_cfg = None
    n_embed, embed_dim, use_mask = 16384, 8, True
    fsc = params.get("first_stage_config")
    if fsc and fsc != "__is_unconditional__":
        fsp = fsc["params"]
        fs_cfg = _ae_cfg(fsp["ddconfig"])
        n_embed = fsp.get("n_embed", 16384)
        embed_dim = fsp.get("embed_dim", 8)
        use_mask = fsp.get("use_mask", False)
    return LatentDiffusion(diff_cfg, unet_cfg, first_stage_cfg=fs_cfg, n_embed=n_embed,
                           embed_dim=embed_dim, use_mask=use_mask, cond_stage=cond_stage,
                           unet=unet, dtype=dtype)


def cube_vae_cfg(params: Dict[str, Any]) -> SparseVAEConfig:
    """``geoconfig``/``unetconfig``/``lossconfig`` -> the fixed-capacity
    ``SparseVAEConfig``, as JAX's ``_cube_cfg``: channels ``f_maps * 2**l``
    over ``tree_depth`` levels, latent ``max(channels[-1] // cut_ratio, 4)``;
    the other keys (``edconfig``, ``neck_bound``, ``structure_weight``,
    ``point_cloud_range``, ...) are not read."""
    geo = params.get("geoconfig", {})
    un = params.get("unetconfig", {}).get("params", {})
    lo = (params.get("lossconfig", {}) or {}).get("params", {})
    base = (lo or {}).get("baseconfig", {})
    depth = geo.get("tree_depth", 3)
    channels = tuple(un.get("f_maps", 32) * (2 ** i) for i in range(depth))
    return SparseVAEConfig(
        num_levels=depth, base_capacity=params.get("base_capacity", 4096),
        channels=channels, latent_dim=max(channels[-1] // un.get("cut_ratio", 16), 4),
        voxel_size=geo.get("voxel_size", 0.1), kl_weight=base.get("kl_weight", 1e-3))


def _build_cube_diffusion(params: Dict[str, Any], in_features: int = 4,
                          **_) -> CubeDiffusion:
    """As JAX's ``build_cube_diffusion``: of the U-Net block only
    ``model_channels``, ``num_res_blocks`` (the block count) and
    ``num_heads`` are read, and the top-level ``scale_by_std`` is not
    (ROADMAP section 3). The first stage, a ``cube_ae``, is built here
    (``in_features`` wide, as the data's ``feats``)."""
    up = params["unet_config"]["params"]
    fsc = params.get("first_stage_config") or {}
    if not isinstance(fsc, dict) or fsc.get("target") not in CUBE_AE_TARGETS:
        raise NotImplementedError("cube_latent_diffusion needs a cube_ae first_stage_config "
                                  "to encode clouds")
    fs_cfg = cube_vae_cfg(fsc.get("params", {}))
    return CubeDiffusion(
        CubeDiffusionConfig(timesteps=params.get("timesteps", 1000),
                            linear_start=params.get("linear_start", 1e-4),
                            linear_end=params.get("linear_end", 2e-2),
                            latent_dim=fs_cfg.latent_dim),
        SparseUNetConfig(in_channels=fs_cfg.latent_dim,
                         model_channels=up.get("model_channels", 64),
                         num_blocks=up.get("num_res_blocks", 2),
                         num_heads=up.get("num_heads", 8)),
        first_stage=SparseVAE(fs_cfg, in_features))


def build_ptv3_cfg(dd: Dict[str, Any], in_features: Optional[int] = None) -> PTv3Config:
    """pointcept's PT-v3m1 dict -> ``PTv3Config``, as JAX's
    ``build_ptv3_cfg``: the first ``enc_patch_size`` serves every level and
    ``grid_size`` keeps its default (0.05). ``in_features``, when given,
    replaces ``in_channels``."""
    patch = dd.get("enc_patch_size", 1024)
    return PTv3Config(
        in_channels=in_features or dd.get("in_channels", 4),
        orders=tuple(dd.get("order", ("z", "z-trans", "hilbert", "hilbert-trans"))),
        patch_size=patch[0] if isinstance(patch, (list, tuple)) else patch,
        enc_depths=tuple(dd.get("enc_depths", (2, 2, 2, 6, 2))),
        enc_channels=tuple(dd.get("enc_channels", (32, 64, 128, 256, 512))),
        enc_heads=tuple(dd.get("enc_num_head", (2, 4, 8, 16, 32))),
        dec_depths=tuple(dd.get("dec_depths", (2, 2, 2, 2))),
        dec_channels=tuple(dd.get("dec_channels", (64, 64, 128, 256))),
        dec_heads=tuple(dd.get("dec_num_head", (4, 4, 8, 16))),
        mlp_ratio=dd.get("mlp_ratio", 4.0),
        drop_path=dd.get("drop_path", 0.0),
        shuffle_orders=dd.get("shuffle_orders", True),
        enable_rpe=dd.get("enable_rpe", False))


def _build_r2dm(params: Dict[str, Any], **_) -> R2DMDiffusion:
    up = params["unet_config"]["params"]
    blocks = up.get("num_residual_blocks", 2)
    return R2DMDiffusion(R2DMConfig(
        image_size=tuple(params.get("image_size", (32, 1024))),
        channels=params.get("channels", 2),
        base_channels=up.get("base_channels", 64),
        channel_mult=tuple(up.get("channel_multiplier", (1, 2, 4, 8))),
        num_res_blocks=blocks[0] if isinstance(blocks, list) else blocks,
        timesteps=params.get("timesteps", 1024)))


def _build_object_ae(params: Dict[str, Any], **_) -> VQModelObject:
    return VQModelObject(ObjectAEConfig(
        num_points=params.get("num_points", 512),
        num_grids=params.get("modelconfig", {}).get("params", {}).get("num_grids", 1024),
        embed_dim=params.get("embed_dim", 1024), n_embed=params.get("n_embed", 4096)))


def _unwrap(d) -> Dict[str, Any]:
    """Both ``{target, params: {...}}`` blocks and bare dicts."""
    d = d or {}
    return d.get("params", d) if isinstance(d, dict) else {}


def _build_dense_decoder(params: Dict[str, Any], in_features: Optional[int] = None,
                         **_) -> DenseDecoder:
    """DenseDecoderV0: ``feat_dim`` from the head block, else
    ``backbone_out_channels``; the YAML's ``num_classes`` is not read."""
    head = _unwrap(params.get("head"))
    return DenseDecoder(build_ptv3_cfg(_unwrap(params.get("backbone")), in_features),
                        GSDecoderConfig(feat_dim=head.get(
                            "feat_dim", params.get("backbone_out_channels", 64))))


def _build_bert_embedder(params: Dict[str, Any], **_) -> torch.nn.Module:
    """``backend``: "compact" (the default) or "x_transformer" (``heads`` and
    the x-transformers ``attn_flags`` read there)."""
    common = dict(n_embed=params.get("n_embed", 640), n_layer=params.get("n_layer", 32),
                  vocab_size=params.get("vocab_size", 30522),
                  max_seq_len=params.get("max_seq_len", 77),
                  embedding_dropout=params.get("embedding_dropout", 0.0))
    if params.get("backend", "compact") in ("x_transformer", "xt"):
        return E.XTransformerBERTEmbedder(heads=params.get("heads", 8),
                                          attn_flags=params.get("attn_flags"), **common)
    return E.BERTEmbedder(**common)


def _zoo(model_cls, cfg_cls, fixed: Optional[Dict[str, Any]] = None) -> Callable:
    """The REGISTRY entry of a zoo backbone: it builds the model from
    pointcept kwargs, the keys its config dataclass has (lists as tuples),
    the rest dropped, as JAX's entries do; ``fixed`` overrides (PT-v1's
    block counts)."""
    keys = {f.name for f in dataclasses.fields(cfg_cls)} - set(fixed or {})

    def build(params: Dict[str, Any], **_):
        kw = {k: (tuple(v) if isinstance(v, list) else v)
              for k, v in (params or {}).items() if k in keys}
        return model_cls(cfg_cls(**kw, **(fixed or {})))
    return build


REGISTRY: Dict[str, Callable] = {}
for _names, _fn in (
        (("latent_diffusion", "lidm.models.diffusion.ddpm.LatentDiffusion"),
         _build_latent_diffusion),
        (UNET_TARGETS, _build_unet),
        (LAYOUT_UNET_TARGETS,
         lambda params, **_: LayoutDiffusionUNetModel(build_layout_unet_cfg(params))),
        (LAYOUT_ENCODER_TARGETS,
         lambda params, **_: LayoutTransformerEncoder(build_layout_encoder_cfg(params))),
        (("unet1d", "lidm.modules.unets.unet_1d.UNet1DModel"),
         lambda params, **_: build_unet1d_cfg(params)),
        (("layout_diffusion", "lidm.models.diffusion.ddpm.LayoutDiffusion"),
         _build_layout_diffusion),
        (("vq_model", "lidm.models.autoencoder.VQModel", "lidm.models.ae.autoencoder.VQModel"),
         lambda params, **_: _build_vq(params)),
        (("vq_model_interface", "lidm.models.autoencoder.VQModelInterface",
          "lidm.models.ae.autoencoder.VQModelInterface"),
         lambda params, **_: _build_vq(params, interface=True)),
        (("vq_loss", "lidm.modules.losses.vqperceptual.VQGeoLPIPSWithDiscriminator"),
         _build_vq_loss),
        (CUBE_AE_TARGETS,
         lambda params, in_features=4, **_: SparseVAE(cube_vae_cfg(params), in_features)),
        (CUBE_LDM_TARGETS, _build_cube_diffusion),
        (GAUS_AE_TARGETS, lambda params, **_: _build_vq(params, gaus=True)),
        (KL_AE_TARGETS, lambda params, **_: AutoencoderKL(_ae_cfg(params["ddconfig"]),
                                                          embed_dim=params.get("embed_dim", 8))),
        (R2DM_TARGETS, _build_r2dm),
        (("efficient_unet", "lidm.modules.unets.efficient_unet.EfficientUNet"),
         lambda params, **_: params),   # read inline by r2dm_diffusion
        (OBJECT_AE_TARGETS, _build_object_ae),
        (("vq_loss_1d", "lidm.modules.losses.vqperceptual.VQGeoLPIPSWithDiscriminator1D"),
         lambda params, **_: params),   # the object trainer reads no key of it
        (("identity", "torch.nn.Identity"), lambda params, **_: None),
        (("ptv3", "PT-v3m1"),
         lambda params, in_features=None, **_: PTv3(build_ptv3_cfg(params, in_features))),
        (("dense_decoder", "DenseDecoderV0"), _build_dense_decoder),
        (("gs_decoder_head", "GSDecoder"),
         lambda params, **_: GSDecoderConfig(feat_dim=params.get("feat_dim", 64))),
        (("ptv3_segmentor", "DefaultSegmentorV2"),
         lambda params, in_features=None, **_: PTv3Segmentor(
             build_ptv3_cfg(_unwrap(params.get("backbone")), in_features),
             num_classes=params.get("num_classes", 16),
             backbone_out_channels=params.get("backbone_out_channels", 64))),
        (("class_embedder", "lidm.modules.encoders.modules.ClassEmbedder"),
         lambda params, **_: E.ClassEmbedder(**params)),
        (("spatial_rescaler", "lidm.modules.encoders.modules.SpatialRescaler"),
         lambda params, **_: E.SpatialRescaler(
             n_stages=params.get("n_stages", 1), method=params.get("method", "bilinear"),
             out_channels=params.get("out_channels"),
             wh_factors=tuple(params.get("wh_factors", (0.5, 0.5))),
             in_channels=params.get("in_channels"))),
        (("bert_embedder", "lidm.modules.encoders.modules.BERTEmbedder"), _build_bert_embedder),
        (("ptv2", "PT-v2m2"), _zoo(PointTransformerV2, PTv2Config)),
        (("ptv1_seg26", "PointTransformer-Seg26"),
         _zoo(PointTransformerSeg, PTv1Config, {"blocks": (1, 1, 1, 1, 1)})),
        (("ptv1_seg38", "PointTransformer-Seg38"),
         _zoo(PointTransformerSeg, PTv1Config, {"blocks": (1, 2, 2, 2, 2)})),
        (("ptv1_seg50", "PointTransformer-Seg50"),
         _zoo(PointTransformerSeg, PTv1Config, {"blocks": (1, 2, 3, 5, 2)})),
        (("spunet", "SpUNet-v1m1"), _zoo(SpUNet, SpUNetConfig)),
        (("stratified", "ST-v1m1"), _zoo(StratifiedTransformer, StratifiedConfig)),
        (("octformer", "OctFormer-v1m1"), _zoo(OctFormer, OctFormerConfig)),
        (("swin3d", "Swin3D-v1m1"), _zoo(Swin3DUNet, Swin3DConfig)),
        (("transformer_embedder", "lidm.modules.encoders.modules.TransformerEmbedder"),
         lambda params, **_: E.TransformerEmbedder(
             n_embed=params.get("n_embed", 640), n_layer=params.get("n_layer", 32),
             vocab_size=params.get("vocab_size", 30522),
             max_seq_len=params.get("max_seq_len", 77))),
        (("clip_text", "lidm.modules.encoders.modules.FrozenCLIPTextEmbedder"),
         lambda params, **_: E.FrozenCLIPTextEmbedder()),
        (("clip_multi_text", "lidm.modules.encoders.modules.FrozenClipMultiTextEmbedder"),
         lambda params, **_: E.FrozenClipMultiTextEmbedder(n_views=params.get("n_views", 4))),
        (("clip_multi_image", "lidm.modules.encoders.modules.FrozenClipMultiImageEmbedder"),
         lambda params, **_: E.FrozenClipMultiImageEmbedder(
             out_dim=params.get("out_dim", 512)))):
    for _n in _names:
        REGISTRY[_n] = _fn


def instantiate_from_config(cfg: Dict[str, Any], **kwargs) -> Any:
    """cfg = {target, params} -> model (reference misc_utils semantics)."""
    if cfg in ("__is_unconditional__", "__is_first_stage__"):
        return None
    target = cfg["target"]
    if target not in REGISTRY:
        raise KeyError(f"target {target!r} is not ported yet; ported: "
                       f"{sorted(REGISTRY)}")
    return REGISTRY[target](cfg.get("params", {}), **kwargs)


def load_yaml(path: str) -> Dict[str, Any]:
    import yaml  # imported here: the card machine may lack pyyaml

    with open(path) as f:
        return yaml.safe_load(f)


def apply_dotlist(cfg: Dict[str, Any], overrides) -> Dict[str, Any]:
    """Merge ``a.b.c=value`` overrides into ``cfg`` (values parsed as YAML,
    bare scientific notation as float); intermediate dicts are created as
    needed. Mutates and returns ``cfg``."""
    import yaml

    for item in overrides or []:
        if "=" not in item:
            raise ValueError(f"dotlist override '{item}' must be key=value")
        key, _, raw = item.partition("=")
        val = yaml.safe_load(raw)
        if isinstance(val, str):
            try:
                val = float(val)
            except ValueError:
                pass
        node = cfg
        parts = key.strip().split(".")
        for part in parts[:-1]:
            nxt = node.get(part)
            if not isinstance(nxt, dict):
                nxt = {}
                node[part] = nxt
            node = nxt
        node[parts[-1]] = val
    return cfg
