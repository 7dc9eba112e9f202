"""Plots of draws, diagnostics and training curves (counterpart of
``mile_tpu.viz``). matplotlib is imported by each plot when it is drawn,
so that the package imports where matplotlib is absent."""
from mile_tpu_torch.viz.samples import (  # noqa: F401
    plot_effective_sample_size,
    plot_lppd,
    plot_param_hist,
    plot_param_movement,
    plot_pca,
    plot_per_layer_box,
    plot_split_chain_r_hat,
    plot_variances,
    plot_warmstart_results,
)
