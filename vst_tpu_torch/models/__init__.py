"""Model families of the port (ReCoNet, SD1, SD2; AdaAttN with its VGG19 encoder)."""
