"""The solvers: ADMM (classical and PnP), FISTA/PGD, HQS and RED."""

from pnp_admm_cnc_mri_torch.solvers import admm, fista, hqs, red  # noqa: F401
from pnp_admm_cnc_mri_torch.solvers.admm import (  # noqa: F401
    ADMMState,
    admm_cnc,
    admm_l1,
    init_state,
    pnp_admm_cnc,
    pnp_admm_l1,
    run_admm,
    run_admm_tol,
)
from pnp_admm_cnc_mri_torch.solvers.fista import FISTAState, fista_l1, pnp_fista, run_fista  # noqa: F401
from pnp_admm_cnc_mri_torch.solvers.hqs import pnp_hqs, run_hqs  # noqa: F401
from pnp_admm_cnc_mri_torch.solvers.red import run_red  # noqa: F401
