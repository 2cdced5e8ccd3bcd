"""python -m vulkan_pathtracer_tpu_torch — headless render CLI."""

from vulkan_pathtracer_tpu_torch.app.main import main

raise SystemExit(main())
