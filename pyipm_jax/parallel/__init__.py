from pyipm_jax.parallel.batch import solve_batch, make_batch_solver
