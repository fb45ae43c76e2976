from .pairwise import fused_pairwise_conv_bxf, fused_pairwise_conv_bxf_plain


def launch_counts() -> dict:
    """This process's kernel launches and routed calls so far, by kernel:
    {'launches': {name: n}, 'routed': {name: n}}. The wrappers count in
    module attributes, so a fleet host reports its own through its `stats`
    RPC (serving.fleet.HostServer): no other process can read them."""
    from . import attention as ka
    from . import flash as kf
    from . import pairwise as kp
    launches = {
        'bxf': kp.fused_pairwise_conv_bxf.launches,
        'fwd': kp.fused_pairwise_conv.launches,
        'A': kp.fused_pairwise_conv_bwd.launches_a,
        'B': kp.fused_pairwise_conv_bwd.launches_b,
        'attn_fwd': ka.fused_attention_fwd.launches,
        'attn_bwd': ka.fused_attention_bwd.launches,
        'flash': kf.flash_attention_fwd.launches,
        'bx': kp.fused_pairwise_conv_bx.launches,
        'global': kf.flash_global_attention_fwd.launches}
    routed = {
        'bxf': kp.fused_pairwise_conv_bxf.routed,
        'fwd': kp.fused_pairwise_conv.routed,
        'attn_fwd': ka.fused_attention_fwd.routed,
        'flash': kf.flash_attention_fwd.routed,
        'bx': kp.fused_pairwise_conv_bx.routed,
        'global': kf.flash_global_attention_fwd.routed}
    return dict(launches=launches, routed=routed)
