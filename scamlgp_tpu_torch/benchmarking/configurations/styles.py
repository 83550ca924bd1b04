"""Per-optimizer plot style registry (``scamlgp_tpu/benchmarking/
configurations/styles.py``, the reference's ``styles.py:8-10``).  The
colour is matplotlib's ``tab10`` colour 0, written out so that the module
imports without matplotlib."""

from scamlgp_tpu_torch.bo.optimizer import ScaMLGPBO

#: ``matplotlib.colormaps["tab10"](0)[:3]``
TAB10_0 = (0.12156862745098039, 0.4666666666666667, 0.7058823529411765)

OPTIMIZER_STYLES = {
    ScaMLGPBO: {"color": TAB10_0, "label": "ScaML-GP", "line": "-"},
}
