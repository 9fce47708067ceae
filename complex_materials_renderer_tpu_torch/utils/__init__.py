"""Host utilities: device selection and phase timing."""
