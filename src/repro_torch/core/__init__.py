"""MOCHA core in PyTorch: the paper's algorithm as a library."""
from repro_torch.core.dual import (DualState, FederatedData, compute_v,
                                   dual_objective, duality_gap, init_state,
                                   per_task_error, primal_objective,
                                   primal_weights, r_star, with_xnorm2)
from repro_torch.core.engine import (ENGINES, KernelEngine, LocalEngine,
                                     RoundEngine, get_engine)
from repro_torch.core.losses import (HINGE, LOGISTIC, LOSSES, SMOOTH_HINGE,
                                     SQUARED, Loss, get_loss)
from repro_torch.core.mocha import (HISTORY_KEYS, MochaConfig, RunResult,
                                    run_cocoa)
from repro_torch.core.regularizers import (REGULARIZERS, Clustered,
                                           Graphical, MeanRegularized,
                                           Probabilistic, Regularizer,
                                           sigma_prime, spd_inverse)
from repro_torch.core.subproblem import (active_gram_max_d,
                                         batched_local_sdca, local_sdca,
                                         local_sdca_idx, measure_theta,
                                         resolve_gram, row_norms,
                                         solve_exact, subproblem_value)
from repro_torch.core.systems_model import (NETWORKS, Network, RoundEvent,
                                            SystemsConfig, SystemsTrace,
                                            population_rates)
from repro_torch.core.theta import (BudgetConfig, drop_masked_budgets,
                                    presample_budgets, round_budgets,
                                    round_key_schedule, validate_assumption2)
