"""The epiband gradient launches, dfr and dfs together: their summed bound
(bytes from each launch's plan shapes, counted once, over the card's
memory rate) over their summed device time, in % (kernels layer)."""


def read(r):
    return r.roofline_pct(("epiband_bwd_dfr_kernel", "epiband_bwd_dfs_kernel"),
                          ("epiband_bwd_dfr", "epiband_bwd_dfs"))
