from kvazaar_jax.cli import main

raise SystemExit(main())
