"""Host-side audio: the WAV reader, the mel frontend and mixup."""
