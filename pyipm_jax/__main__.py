from pyipm_jax.cli import main

main()
