"""Model families of the port (ReCoNet, SD1, SD2 with the VGG16 of their
losses; RTNSTV with its VGG19; AdaAttN with its VGG19 encoder)."""
