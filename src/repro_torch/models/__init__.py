"""The port's model substrate (``repro.models`` on PyTorch): the hybrid
(Zamba2) stack and its layers. Import from the modules
(``repro_torch.models.model``); the package does not re-export."""
