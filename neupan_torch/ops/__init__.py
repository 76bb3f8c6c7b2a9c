from neupan_torch.ops.qp import ADMMConfig, QPData, QPSolution, solve_qp, solve_qp_batch  # noqa: F401
