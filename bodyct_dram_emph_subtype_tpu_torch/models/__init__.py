"""The med3d ResNet / dRAM model zoo as ``nn.Module``s."""
