from sydr_tpu_torch.main import main

raise SystemExit(main())
