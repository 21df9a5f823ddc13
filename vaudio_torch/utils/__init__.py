"""Display-space helpers and the debug-surface renderers — the PyTorch
port's copies of :mod:`vaudio.utils.display` and :mod:`vaudio.utils.render`
(numpy and the standard library; nothing here touches the device)."""
